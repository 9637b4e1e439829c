"""The masked counting product's share of its roofline, in percent: the
least time the operands' work needs (``graphbench.roofline``, summed over
the products of one counted refresh step) over the device time of the
kernels that compute them in that step (``count_mm*``, and ``split3``,
which splits the left operand for it).  Nothing to read where no such
kernel ran."""

from graphbench import roofline


def _ours(name: str) -> bool:
    return "count_mm" in name or "split3" in name


def read(r):
    if r.work_trace is None or not r.work:
        return None
    seconds = r.work_trace.device_seconds(_ours)
    if seconds <= 0:
        return None
    least = sum(roofline.least_seconds(ops, nbytes)[0]
                for ops, nbytes in r.work)
    return 100.0 * least / seconds
