"""Counting products the program ran in the counted refresh step: every
product it built through ``repro_torch.core.semiring.count_mm_against``
that ran (``drivers.counting_products``), the forward levels from each
source's cut and the backward levels.  Nothing to read where no step was
counted."""


def read(r):
    if r.work_trace is None:
        return None
    return float(len(r.work))
