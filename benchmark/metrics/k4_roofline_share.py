"""K4's share of its roofline: the bound of one launch over the CMPC
team's problems (games x t_grid candidates; ``roofline.k4_bound_s``) over
K4's device time a launch in the traced steps (kernels named
``cmpc_sqp_kernel``)."""

from benchmark import harness, roofline


def read(run):
    tr = run.get("trace")
    if run["kind"] != "matchup" or not tr:
        return None
    n = harness.kernel_count(tr, "cmpc_sqp_kernel")
    if not n:
        return None
    t = harness.kernel_seconds(tr, "cmpc_sqp_kernel") / n
    mpc = run["cfg"]["MpcParams"]
    P = run["games"] * mpc["t_grid"]
    return 100.0 * roofline.k4_bound_s(P, mpc) / t
