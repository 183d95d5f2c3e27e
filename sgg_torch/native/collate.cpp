// Native graph-batch packing: the host-side hot loop of the port's input
// pipeline (sgg_torch/data/graph_batch.py:pack_ragged).
//
// The reference collates ragged per-image scene graphs in Python by
// concatenating variable-length tensors with image-index columns
// (reference dataloaders/blob.py:128-168). The port packs graphs into
// fixed-shape padded buffers instead, (B, N_max) nodes and (B, E_max) edges
// with validity masks, so every step sees the same shapes. The packing runs
// once a batch on the host; in C++ it stays off the Python interpreter.
// The port's copy of sgg_tpu/native/collate.cpp, kept byte for byte in its
// code. Built and bound by sgg_torch/native/__init__.py.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Packs ragged per-image graphs into padded fixed-shape buffers.
//
// Inputs (ragged, concatenated over B images):
//   boxes:        total_nodes x 4 floats
//   classes:      total_nodes int32
//   node_offsets: B+1 int64 prefix offsets into boxes/classes
//   rels:         total_rels x 3 int32 (subj_local, obj_local, predicate)
//   rel_offsets:  B+1 int64 prefix offsets into rels
// Outputs (caller-allocated, fully overwritten):
//   out_boxes:     B x n_max x 4 floats (padding = 0)
//   out_classes:   B x n_max int32 (padding = 0 = background)
//   out_node_mask: B x n_max uint8
//   out_rels:      B x e_max x 3 int32 (padding = 0,0,0)
//   out_rel_mask:  B x e_max uint8
//
// Nodes beyond n_max are truncated; relations referencing truncated nodes or
// beyond e_max are dropped. Returns the number of dropped relations.
int64_t pack_graph_batch(const float* boxes, const int32_t* classes,
                         const int64_t* node_offsets, const int32_t* rels,
                         const int64_t* rel_offsets, int64_t B, int64_t n_max,
                         int64_t e_max, float* out_boxes, int32_t* out_classes,
                         uint8_t* out_node_mask, int32_t* out_rels,
                         uint8_t* out_rel_mask) {
  std::memset(out_boxes, 0, sizeof(float) * B * n_max * 4);
  std::memset(out_classes, 0, sizeof(int32_t) * B * n_max);
  std::memset(out_node_mask, 0, sizeof(uint8_t) * B * n_max);
  std::memset(out_rels, 0, sizeof(int32_t) * B * e_max * 3);
  std::memset(out_rel_mask, 0, sizeof(uint8_t) * B * e_max);

  int64_t dropped = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int64_t ns = node_offsets[b];
    const int64_t ne = node_offsets[b + 1];
    const int64_t n = std::min(ne - ns, n_max);
    std::memcpy(out_boxes + b * n_max * 4, boxes + ns * 4,
                sizeof(float) * n * 4);
    std::memcpy(out_classes + b * n_max, classes + ns, sizeof(int32_t) * n);
    std::fill(out_node_mask + b * n_max, out_node_mask + b * n_max + n,
              uint8_t{1});

    const int64_t rs = rel_offsets[b];
    const int64_t re = rel_offsets[b + 1];
    int64_t w = 0;
    for (int64_t r = rs; r < re; ++r) {
      const int32_t s = rels[r * 3 + 0];
      const int32_t o = rels[r * 3 + 1];
      if (s >= n || o >= n || s < 0 || o < 0 || w >= e_max) {
        ++dropped;
        continue;
      }
      int32_t* dst = out_rels + (b * e_max + w) * 3;
      dst[0] = s;
      dst[1] = o;
      dst[2] = rels[r * 3 + 2];
      out_rel_mask[b * e_max + w] = 1;
      ++w;
    }
  }
  return dropped;
}

}  // extern "C"
