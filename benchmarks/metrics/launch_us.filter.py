"""Mean host-clock time of the ``filter_chain`` call a request, over the
window: the wrapper's checks, cached plans and launch, returning once the
kernel is queued."""


def read(run):
    if run.cfg["name"] != "filter_fusion":
        return None
    mean = run.spans.mean_s("launch")
    return None if mean is None else 1e6 * mean
