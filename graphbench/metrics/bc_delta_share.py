"""Share of the window's ``bc_scores`` refreshes that ran the delta path
(``bc_scores_stats``), in percent."""


def read(r):
    modes = [r.counters.get(f"bc_scores.{m}", 0)
             for m in ("unchanged", "delta", "full")]
    if not sum(modes):
        return None
    return 100.0 * modes[1] / sum(modes)
