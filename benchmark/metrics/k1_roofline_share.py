"""K1's share of its roofline: the bound of one control step of a card's
games (``roofline.k1_bound_s``) over K1's device time a step in the traced
sweep (kernels named ``exact_step_kernel``, the export and the resume)."""

from benchmark import harness, roofline


def read(run):
    tr = run.get("trace")
    if run["kind"] != "sweep" or not tr:
        return None
    k1 = harness.kernel_seconds(tr, "exact_step_kernel") / tr["steps"]
    if k1 <= 0:
        return None
    B = run["games"] // run["world"]
    G = run["cfg"]["SimParams"]["grid_points"]
    return 100.0 * roofline.k1_bound_s(B, G) / k1
