"""Host ms a pair inside graphs.CapturedCall.__call__ (the copy into the
static inputs, the graph launch, the copies of its outputs), over the
window after the traced stretch."""

SPANS = ("depthestimation_torch.graphs:CapturedCall.__call__",)


def read(view):
    spans = view.spans.get(SPANS[0])
    if not spans or not view.span_items:
        return None
    return 1e3 * sum(spans) / view.span_items
