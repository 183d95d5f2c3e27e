"""Host milliseconds an image inside the evaluators: the calls of
``SGGEvaluator`` and ``MeanRecallEvaluator`` (``add_image`` and
``results``, with and without graph constraint, both regimes) in the
window, timed from outside by wrapping them (``evaluation.Probe``), over
the set's images."""


def read(run):
    ev = run.ev
    if ev is None or not ev.images or not ev.evaluator:
        return None
    return ev.evaluator_s() * 1e3 / ev.images
