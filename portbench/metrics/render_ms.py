"""Host milliseconds a panorama spends in the stage's call
(``stitch``): a span of the benchmark's own that ends in a device sync
(traced runs only), averaged over the window's panoramas that ran
outside the profiler."""
MOVES = "pano_s"
SPAN = "render"


def read(trace):
    got = trace.spans.get(SPAN)
    return 1e3 * sum(got) / len(got) if got else None
