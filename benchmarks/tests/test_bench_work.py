"""The frozen operation counts (``benchmarks/work.py``) agree with
``FlopCounterMode`` on the plain reference at tiny sizes where nothing is
padded: every node and edge slot real, RoIAlign (a kernel with a count of
its own) stood in by a copy. The eval count, which runs fc6 once an
unordered pair, is held against the program's own eval forward, which
dedups the unions so; and the ladder rule on hand-made batches (``test_bench_rehearsal.py`` holds it
against the rungs ``val_epoch`` ran)."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import work
from benchmarks.reference import gan as rg
from benchmarks.reference import model as rm

CFG = {"fmap_channels": 512, "obj_dim": 48, "hidden_dim": 16, "mp_iter": 3,
       "num_classes": 11, "num_predicates": 7, "rels_per_img": 1024,
       "compute_dtype": "float32", "alpha": 1.0, "beta": 1.0, "gamma": 1.0,
       "largeD": True}


def counted(fn):
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def test_trunk():
    P = rm.make_weights(rm.param_spec(CFG), 1, "cpu")
    images = torch.randint(0, 255, (2, 32, 32, 3), dtype=torch.uint8)
    num = rm.Numerics("bf16")
    with torch.no_grad():
        n = counted(lambda: rm.trunk(P, images, num))
    assert n == work.trunk_flops(2, 32)


def full_graph(B, N):
    pairs = torch.tensor([(i, j) for i in range(N) for j in range(N)
                          if i != j])[None].expand(B, -1, -1)
    return pairs, torch.ones(pairs.shape[:2], dtype=torch.bool)


@pytest.mark.parametrize("B,N", [(1, 3), (2, 4)])
def test_relation_model(monkeypatch, B, N):
    P = rm.make_weights(rm.param_spec(CFG), 2, "cpu")
    for k, t in P.items():
        t.requires_grad_(not rm.frozen(k))
    monkeypatch.setattr(rm, "roi_align", lambda fmap, boxes: fmap[
        :, None, :7, :7, :].expand(-1, boxes.shape[1], -1, -1, -1)
        .contiguous())
    pairs, mask = full_graph(B, N)
    x = torch.rand(B, N, 2) * 40
    boxes = torch.cat([x, x + 8 + torch.rand(B, N, 2) * 30], -1)
    batch = {"boxes": boxes, "node_mask": torch.ones(B, N, dtype=torch.bool),
             "classes": torch.randint(1, 11, (B, N))}
    fmap = torch.randn(B, 8, 8, 512)
    labels = torch.randint(0, 7, pairs.shape[:2])
    gen = torch.Generator().manual_seed(0)

    def step():
        out = rm.relation_model(P, batch, pairs, mask, gen, CFG,
                                rm.Numerics("bf16"), fmap=fmap)
        sum(rm.sgg_losses(out, batch["classes"], labels, batch, mask,
                          (1.0, 1.0, 1.0)).values()).backward()

    m = B * N * (N - 1)
    assert counted(step) == work.relation_flops(
        B * N, m, CFG, dense_incidence=(B * N * (N - 1), N))


def test_generator():
    P = rg.make(rg.param_spec(CFG), 3, "cpu")
    for t in P.values():
        t.requires_grad_(True)
    B, N, side = 2, 3, 8
    rels = torch.tensor([[[0, 1, 2], [1, 2, 3]], [[2, 0, 1], [0, 2, 4]]])
    x = torch.rand(B, N, 2) * 0.5
    boxes01 = torch.cat([x, x + 0.2 + torch.rand(B, N, 2) * 0.3], -1)
    classes = torch.randint(1, 11, (B, N))
    nm = torch.ones(B, N, dtype=torch.bool)
    rm_ = torch.ones(B, 2, dtype=torch.bool)

    def step():
        rg.generate(P, classes, boxes01, rels, nm, rm_, side,
                    rm.Numerics("bf16")).sum().backward()

    prod, sums = work.generator_flops(B * (N + 1), B * (2 + 2 * N), B, side,
                                      dense_nodes=N + 1)
    assert counted(step) == 3 * prod + 2 * sums


def test_discriminators():
    P = rg.make(rg.param_spec(CFG), 4, "cpu")
    S = rg.make(rg.sn_spec(CFG), 5, "cpu")
    num = rm.Numerics("bf16")
    feats = torch.randn(2, 5, 7, 7, 512)
    labels = torch.randint(0, 11, (2, 5))
    with torch.no_grad():
        n = counted(lambda: rg.d_patch(P, S, "D_nodes", feats, labels, 11,
                                       num))
        assert n == 10 * work.d_patch_flops(512 + 11) + \
            work.spectral_norm_flops(work.d_patch_convs(512 + 11))
        for side in (37, 12):
            maps = torch.randn(3, side, side, 512)
            n = counted(lambda: rg.d_global(P, S, maps, CFG, num))
            assert n == 3 * work.d_global_flops(side, True) + \
                work.spectral_norm_flops(work.d_global_convs(True))


def test_kernel_work_counts_each_byte_once():
    flops, nbytes = work.roi_align_work(10, 2, 64, 512, 2)
    assert nbytes == 2 * 4 * 4 * 512 * 2 + 10 * 16 + 10 * 49 * 512 * 2
    assert flops == 2 * 4 * 4 * 10 * 49 * 512
    flops, nbytes = work.vgg_conv1_work(2, 16, 2)
    assert flops == 2 * 2 * 256 * 64 * 27


EVAL_CFG = dict(CFG, im_scale=32, mode="sgcls", use_bias=False,
                backbone="vgg16", edge_model="motifs")


def pool_stand_in(fmap, boxes, *args, **kw):
    return fmap[:, None, :1, :1, :].expand(-1, boxes.shape[1], 7, 7,
                                           -1).contiguous()


def eval_inputs(B, N):
    pairs, mask = full_graph(B, N)
    x = torch.rand(B, N, 2) * 20
    boxes = torch.cat([x, x + 4 + torch.rand(B, N, 2) * 8], -1)
    images = torch.randint(0, 255, (B, 32, 32, 3), dtype=torch.uint8)
    return pairs, mask, boxes, images


@pytest.mark.parametrize("B,N", [(1, 3), (2, 4)])
def test_eval_forward_with_the_unions_dedup(monkeypatch, B, N):
    from benchmarks.families import imp
    from sgg_torch.models import relhead
    cfg = dict(EVAL_CFG, compute_dtype="bfloat16")
    model = imp.relation_model(cfg, "cpu", rm.make_weights(
        rm.param_spec(cfg), 6, "cpu", rm.stored_types(cfg)))
    monkeypatch.setattr(relhead, "roi_align", pool_stand_in)
    pairs, mask, boxes, images = eval_inputs(B, N)
    with torch.no_grad():
        n = counted(lambda: model(images, boxes, torch.ones(B, N).long(),
                                  pairs, mask, mode="sgcls",
                                  dedup_unions=True))
    assert n == B * work.eval_flops(N, cfg,
                                    dense_incidence=(N * (N - 1), N))


def test_ladder_rule():
    cfg = {"max_nodes": 64, "pair_ladder": [128, 512, 2048, None]}
    nodes = work.eval_nodes([2, 62, 11], cfg)
    assert nodes == 64
    rungs = work.ladder(cfg, nodes)
    assert rungs == [128, 512, 2048, 64 * 63]
    assert work.rung([2, 12], rungs) == 512          # 132 pairs
    assert work.rung([2, 11], rungs) == 128          # 110 pairs
    assert work.rung([46, 3], rungs) == 64 * 63      # 2070: dense
    assert work.rung([45, 3], rungs) == 2048         # 1980
    assert work.eval_nodes([70], cfg) == 72
    assert work.ladder(dict(cfg, max_nodes=8), 8) == [8 * 7]
