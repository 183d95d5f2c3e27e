"""BERT plausibility scoring of (perturbed) triplets.

Counterpart of ``sgg_tpu/augment/bert.py`` (reference
``augment/bert.py``): queries a masked LM (``bert-base-uncased`` through
huggingface transformers) with templated sentences like "the man is riding
the [MASK], <context triplets>" to score how plausible a perturbed subject
or object is. Analysis code, not the training loop (the reference also
uses it only in notebooks).

Nothing is downloaded: the model is read from a local directory or the
local transformers cache (``local_files_only``), and construction raises
where ``transformers`` is missing. ``transformers`` is imported only
there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class BERTScorer:
    def __init__(self, model_name: str = "bert-base-uncased",
                 min_score: float = 0.0,
                 obj_classes: Optional[Sequence[str]] = None,
                 rel_classes: Optional[Sequence[str]] = None,
                 device: str = "cpu"):
        try:
            import torch  # noqa: F401
            from transformers import BertForMaskedLM, BertTokenizer
        except ImportError as e:
            raise RuntimeError(f"transformers/torch unavailable: {e}")
        self.tokenizer = BertTokenizer.from_pretrained(
            model_name, local_files_only=True)
        self.model = BertForMaskedLM.from_pretrained(
            model_name, local_files_only=True).to(device)
        self.model.eval()
        self.device = device
        self.min_score = min_score
        self.obj_classes = obj_classes
        self.rel_classes = rel_classes

    # simple whitespace tokenizer — the wordpiece tokenizer mangles rare VG
    # classes like "giraffe"/"surfboard" (reference bert.py:20-27)
    def _tokenize(self, s: str) -> List[str]:
        return ["[CLS]"] + s.replace(",", " ,").split(" ") + [".", "[SEP]"]

    def _mask_logits(self, text: str, masked_index: int):
        import torch
        toks = self._tokenize(text)
        toks[masked_index] = "[MASK]"
        ids = self.tokenizer.convert_tokens_to_ids(toks)
        with torch.no_grad():
            out = self.model(torch.tensor([ids]).to(self.device),
                             torch.tensor([[1] * len(ids)]).to(self.device))
        return out[0].squeeze()[masked_index]

    def predict_token(self, text: str, masked_index: int,
                      classes: Optional[Sequence[str]] = None,
                      topk: int = 5) -> List[Tuple[str, float]]:
        """Top-k in-vocabulary completions of the mask, with the
        plural-stripping heuristic (bert.py:26-61)."""
        import torch
        logits = self._mask_logits(text, masked_index)
        pairs: List[Tuple[str, float]] = []
        scores, inds = torch.topk(logits, k=max(topk * 4, topk))
        for score, ind in zip(scores, inds):
            if score < self.min_score:
                break
            word = self.tokenizer.decode([ind]).strip()
            if len(word) < 2 or word.startswith("#"):
                continue
            if classes is not None and word not in classes:
                if word.endswith("s") and word[:-1] in classes:
                    pairs.append((word[:-1], float(score)))
                continue
            else:
                pairs.append((word, float(score)))
            if len(pairs) >= topk:
                break
        return pairs

    def score_word(self, text: str, masked_index: int,
                   target: str) -> float:
        """Log-score of ``target`` at the masked position (bert.py:76-90)."""
        logits = self._mask_logits(text, masked_index)
        idx = self.tokenizer.convert_tokens_to_ids([target])[0]
        return float(logits[idx])

    def score_triplet(self, subj: str, predicate: str, obj: str,
                      context: str = "", is_subject: bool = True) -> float:
        """Templated triplet plausibility (bert.py:93-123): score the subject
        or object slot of "the <subj> [is] <pred> the <obj>, <context>"."""
        r_words = predicate.split(" ")
        if is_subject:
            masked_index = 2
            verb = "is" if "ing" in predicate else ""
        else:
            masked_index = 4 + len(r_words)
            if "ing" in predicate:
                verb = "are" if subj in ("men", "people") else "is"
                masked_index += 1
            else:
                verb = ""
        query = f"the {subj} {verb} {predicate} the {obj}{context}"
        query = query.replace("_", " ").replace("  ", " ")
        return self.score_word(query, masked_index,
                               subj if is_subject else obj)
