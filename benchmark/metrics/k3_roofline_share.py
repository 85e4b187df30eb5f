"""K3's share of its roofline: the bound of one launch over the DMPC
team's problems (games x 2 players x t_grid candidates;
``roofline.k3_bound_s``) over K3's device time a launch in the traced
steps (kernels named ``dmpc_sqp_kernel``)."""

from benchmark import harness, roofline


def read(run):
    tr = run.get("trace")
    if run["kind"] != "matchup" or not tr:
        return None
    n = harness.kernel_count(tr, "dmpc_sqp_kernel")
    if not n:
        return None
    t = harness.kernel_seconds(tr, "dmpc_sqp_kernel") / n
    mpc = run["cfg"]["MpcParams"]
    P = run["games"] * 2 * mpc["t_grid"]
    return 100.0 * roofline.k3_bound_s(P, mpc) / t
