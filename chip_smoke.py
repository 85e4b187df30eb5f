#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each failing loudly (nothing here catches an error):

0. the card's name and power limit (nvidia-smi), then the build of the
   hand-written CUDA kernel K1 (csrc/exact_step.cu) from this checkout;
1. K1 against its plain PyTorch version on the card, from common states:
   (a) mode exact at B=8192 on Monte-Carlo starts, uniform schedules;
   (b) corner-grinding games (B=1024, pre-ground 26 steps by the kernel),
       which drive the event loop to its cap;
   (c) two-phase (exact_export + exact_resume) bitwise equal to one-phase
       in the kernel, through both the compacted and the overflow path;
   (d) stochastic mode with identical noise planes, and noise=0 bitwise
       equal to the deterministic kernel;
2. the main path: bench.py's workload (B=8192 games, 400 control steps,
   per-game U(-8, 8) schedules held 10 steps, winning_score=4, two-phase
   with compact_frac=16) through ``monte_carlo``, timed after a warm-up,
   with K1's launch counts of that run; its first 64 games are held
   against the same sweep run by the plain version on the CPU;
3. K1's time per control step at the main path's shapes beside its bound
   and the plain version's time, as one JSON line ``{"kernels": [...]}``.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device
the script exits 1 before printing any result.
"""

import importlib
import json
import subprocess
import sys
import time

import torch

B_MAIN, N_STEPS, HOLD = 8192, 400, 10
H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12              # f32 outside the tensor cores


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps=1):
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    out = None
    for _ in range(reps):
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps, out


def maxdiff(a, b):
    return float((a.double() - b.double()).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import robogame_tpu_torch as rt
    from robogame_tpu_torch import kernels
    from robogame_tpu_torch.physics import exact_step as ex
    mc_mod = importlib.import_module("robogame_tpu_torch.parallel.monte_carlo")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 0: card, build -------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    print(f"phase0 build K1: {build_s:.2f} s (nvcc {kernels.build_seconds})"
          f"  [{card}]", flush=True)

    P1 = rt.SimParams(engine="pallas_exact", two_phase=False)
    errs = []

    def compare(tag, s, u, params, xtol, dtol, npl=None, rpl=None):
        """One mode-exact K1 step and its plain version from state s."""
        planes = ex._to_planes(s)
        up = ex._u_plane(u, s.x.shape[0])
        T = ex._tabs(params, dev)
        k = ex._kernel_call(planes, up, params, npl, mode="exact",
                            rnoise_plane=rpl)
        p = ex.exact_step_plain(T, *planes[:1], up, *planes[1:], npl, rpl,
                                None, None, "exact", 49)
        p = (p[0], p[1][0:8], p[1][8:24])
        torch.cuda.synchronize()
        dx, dm = maxdiff(k[0], p[0]), maxdiff(k[2], p[2])
        dmeta = maxdiff(k[1][0:4], p[1][0:4])
        print(f"phase1 {tag}: max|dx| {dx:.3g} max|ddmg| {dm:.3g} "
              f"max|dmeta| {dmeta:.3g} events/game "
              f"{float(k[1][3].mean()):.3f}", flush=True)
        check(torch.equal(k[1][0:2], p[1][0:2]), f"{tag}: scores differ")
        check(dx <= xtol and dm <= dtol * (1 + float(p[2].abs().max())),
              f"{tag}: K1 disagrees with its plain version")
        errs.append(max(dx, dm))
        return k

    # ---- phase 1a: exact at B=8192 on MC starts, uniform schedule -------
    sched_g = torch.Generator().manual_seed(0)
    u_uni = (torch.rand((N_STEPS // HOLD, B_MAIN, 4, 2), generator=sched_g)
             * 16.0 - 8.0).to(dev)
    mcp = rt.McParams(num_runs=B_MAIN, randomize_x0=True)
    s = mc_mod._initial_states(P1, mcp, device=dev)
    for k in range(30):
        s = rt.step_batch(s, u_uni[k // HOLD], P1, device=dev)
    for k in range(30, 33):
        compare(f"(a) exact B={B_MAIN} step {k}", s, u_uni[k // HOLD], P1,
                1e-4, 1e-4)
        s = rt.step_batch(s, u_uni[k // HOLD], P1, device=dev)

    # ---- phase 1b: corner grinding --------------------------------------
    Bc = 1024
    corner = (torch.randint(0, 2, (Bc, 1, 2), generator=sched_g) * 16.0
              - 8.0).expand(Bc, 4, 2).contiguous().to(dev)
    sc = mc_mod._initial_states(P1, rt.McParams(num_runs=Bc,
                                                randomize_x0=True), dev)
    for _ in range(26):
        sc = rt.step_batch(sc, corner, P1, device=dev)
    deepest = 0.0
    for k in range(3):
        out = compare(f"(b) corner B={Bc} step {26 + k}", sc, corner, P1,
                      5e-3, 2e-3)
        deepest = max(deepest, float(out[1][3].max()))
        sc = rt.step_batch(sc, corner, P1, device=dev)
    check(deepest >= 49, "(b) no game reached the event cap")

    # ---- phase 1c: two-phase == one-phase, compacted and overflow -------
    # (the export and resume modes are held against the plain version in
    # phase 3, at the main path's shapes)
    for tag, st, u in (("compact", s, u_uni[3]), ("overflow", sc, corner)):
        B = st.x.shape[0]
        planes = ex._to_planes(st)
        up = ex._u_plane(u, B)
        (_, m1, _), _, _ = ex._kernel_call(planes, up, P1,
                                           mode="exact_export", cap=1)
        n_pend = int(m1[5].sum())
        check(n_pend > 0, f"(c) {tag}: no game pending after phase 1")
        # compact: a budget just above the pending count; overflow: one
        # block of lanes
        frac = B // (-(-n_pend // ex.BLOCK) * ex.BLOCK) if tag == "compact" \
            else B // ex.BLOCK
        p2 = P1.replace(two_phase=True, compact_frac=max(frac, 1))
        K = ex._compact_lanes(B, p2)
        one = ex._kernel_call(planes, up, P1, mode="exact")
        two = ex._twophase_planes_exact(planes, up, p2)
        torch.cuda.synchronize()
        rows = [0, 1, 2, 3, 5]          # meta row 4 counts this call's trips
        check(torch.equal(one[0], two[0]) and torch.equal(one[2], two[2])
              and torch.equal(one[1][rows], two[1][rows]),
              f"(c) {tag}: two-phase differs from one-phase")
        if tag == "compact":
            check(0 < n_pend <= K < B, f"(c) compact path not taken "
                  f"({n_pend} pending, K={K})")
        else:
            check(n_pend > K, f"(c) overflow path not taken ({n_pend})")
        print(f"phase1 (c) {tag}: B={B} K={K} pending={n_pend}: two-phase "
              f"== one-phase bitwise", flush=True)

    # ---- phase 1d: stochastic with identical planes; noise=0 ------------
    ps = P1.replace(stochastic=True, noise=1.0)
    npl, rpl, _ = ex._noise_planes(sc, ps)
    compare(f"(d) stochastic B={Bc}", sc, corner, ps, 5e-3, 2e-3, npl, rpl)
    p0 = P1.replace(stochastic=True, noise=0.0)
    z0, r0, _ = ex._noise_planes(sc, p0)
    planes = ex._to_planes(sc)
    up = ex._u_plane(corner, Bc)
    det = ex._kernel_call(planes, up, P1, mode="exact")
    sto = ex._kernel_call(planes, up, p0, z0, mode="exact", rnoise_plane=r0)
    check(all(torch.equal(a, b) for a, b in zip(det, sto)),
          "(d) noise=0 differs from deterministic")
    print("phase1 (d) noise=0 == deterministic bitwise", flush=True)

    # ---- phase 2: the main path -----------------------------------------
    pm = rt.SimParams(engine="pallas_exact", winning_score=4,
                      two_phase=True, phase1_iters=1, compact_frac=16)
    mc_main = rt.McParams(num_runs=B_MAIN, T=20.0,
                          randomize_x0=True)

    def schedule(ps_, states):
        k, u_base = ps_
        return (k + 1, u_base), u_base[k // HOLD]

    warm = rt.monte_carlo(pm, rt.McParams(num_runs=B_MAIN, T=1.0,
                                          randomize_x0=True),
                          policy=schedule, policy_state=(0, u_uni),
                          device=dev)
    _ = warm.scores.cpu()
    kernels.reset_launches()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    res = rt.monte_carlo(pm, mc_main, policy=schedule,
                         policy_state=(0, u_uni), device=dev)
    ev1.record()
    scores = res.scores.cpu()
    wall = time.perf_counter() - t0
    dev_ms = ev0.elapsed_time(ev1)
    main_launches = dict(kernels.launches)
    rate = B_MAIN * N_STEPS / wall
    print(f"phase2 main path: B={B_MAIN} x {N_STEPS} steps in {wall:.3f} s "
          f"wall ({dev_ms:.1f} ms between CUDA events): {rate:.1f} "
          f"control-steps/s  [{card}]", flush=True)
    print(f"phase2 K1 launches: {main_launches}", flush=True)
    check(main_launches["exact_export"] >= N_STEPS and
          main_launches["exact_resume"] >= N_STEPS,
          "main path did not run the two-phase kernel every step")
    check(scores.shape == (B_MAIN, 2) and res.damage.shape == (B_MAIN, 4, 4)
          and bool(torch.isfinite(res.damage).all()),
          "main path outputs malformed")
    check(bool(((scores >= 0) & (scores <= pm.winning_score)).all()),
          "scores out of range")
    t_fin = res.t_final.cpu()
    undecided = (scores < pm.winning_score).all(dim=1)
    check(bool(undecided.any()) and bool(
        (t_fin[undecided] - N_STEPS * pm.dt).abs().max() < 1e-3),
        "undecided games did not run the full game")
    agg = rt.aggregate(res)
    print(f"phase2 aggregate: {json.dumps(agg)}", flush=True)
    # the first 64 games, swept by the plain version on the CPU
    nref = 64
    mc_ref = rt.McParams(num_runs=nref, T=2.0, randomize_x0=True)
    ref_cpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :nref].cpu()),
                             device="cpu")
    ref_gpu = rt.monte_carlo(pm, mc_ref, policy=schedule,
                             policy_state=(0, u_uni[:, :nref]), device=dev)
    check(torch.equal(ref_cpu.scores, ref_gpu.scores.cpu()),
          "main path scores differ from the plain version on the CPU")
    dref = maxdiff(ref_gpu.damage.cpu(), ref_cpu.damage)
    check(dref <= 5e-4, f"main path damage vs plain CPU sweep: {dref}")
    print(f"phase2 check: {nref} games x 40 steps on the card == plain "
          f"version on the CPU (scores equal, max|ddmg| {dref:.3g})",
          flush=True)

    # ---- phase 3: K1 time per control step at the main path's shapes ----
    sm = mc_mod._initial_states(pm, mc_main, device=dev)
    sm, _ = mc_mod._run_batch(sm, pm, 200, schedule, (0, u_uni), device=dev)
    planes = ex._to_planes(sm)
    up = ex._u_plane(u_uni[20], B_MAIN)
    T = ex._tabs(pm, dev)
    run_export = lambda: kernels.exact_step(
        T.M6, T.consts, planes[0], up, planes[1], planes[2], None, None,
        None, None, "exact_export", 1)
    for _ in range(3):
        run_export()
    exp_ms, (xo, aux, grid, carry) = cuda_ms(run_export, reps=20)
    n_pend = int(aux[5].sum())
    K = ex._compact_lanes(B_MAIN, pm)
    K = K if n_pend <= K else B_MAIN        # the overflow guard's resume
    idx = torch.argsort(-aux[5], stable=True)[:K]
    g_in = [a[:, idx].contiguous() for a in (*planes, up, carry)]
    grid_k = grid[..., idx].contiguous()
    run_resume = lambda: kernels.exact_step(
        T.M6, T.consts, g_in[0], g_in[3], g_in[1], g_in[2], None, None,
        grid_k, g_in[4], "exact_resume", 48)
    for _ in range(3):
        run_resume()
    res_ms, (_, aux_r, _, _) = cuda_ms(run_resume, reps=20)
    pl_exp_ms, pl_exp = cuda_ms(lambda: ex.exact_step_plain(
        T, planes[0], up, planes[1], planes[2], None, None, None, None,
        "exact_export", 1))
    pl_res_ms, pl_res = cuda_ms(lambda: ex.exact_step_plain(
        T, g_in[0], g_in[3], g_in[1], g_in[2], None, None, grid_k, g_in[4],
        "exact_resume", 48))
    err3 = max(maxdiff(xo, pl_exp[0]), maxdiff(aux, pl_exp[1]),
               maxdiff(grid, pl_exp[2]), maxdiff(aux_r, pl_res[1]))
    check(err3 <= 5e-3, f"phase3: K1 vs plain {err3}")
    errs.append(err3)
    # bound: each input read once, each output written once (f32) ...
    K1c = pm.grid_points + 1
    table = T.M6.numel() * 4
    bytes_exp = 4 * B_MAIN * (20 + 10 + 8 + 16 + 20 + 24 + 20 * K1c + 48)
    bytes_res = 4 * K * (20 + 10 + 8 + 16 + 20 * K1c + 48 + 20 + 24)
    nbytes = bytes_exp + bytes_res + 2 * table
    # ... and a lower count of the f32 operations: the populate (6 mul +
    # 5 add per grid cell) and ~200 per resolved event (two partial RK4s
    # per entity and the impulse); detect and re-propagation not counted
    events = float(aux[3].sum()) + float(aux_r[4].sum())
    ops = 11 * 20 * K1c * B_MAIN + 200 * events
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    kern = {
        "name": "K1 exact_step (exact_export + exact_resume per step)",
        "route": "cuda",
        "source": "robogame_tpu_torch/csrc/exact_step.cu",
        "replaces": "robogame_tpu/physics/pallas_step.py:130",
        "launches": sum(main_launches.values()),
        "max_abs_err": max(errs),
        "ms": exp_ms + res_ms,
        "plain_ms": pl_exp_ms + pl_res_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(f"phase3 K1 at B={B_MAIN} (step 200, pending {n_pend}, resume "
          f"over {K}): "
          f"export {exp_ms:.4f} ms + resume {res_ms:.4f} ms; plain "
          f"{pl_exp_ms:.1f} + {pl_res_ms:.1f} ms; bound {t_bytes:.4f} ms "
          f"bytes / {t_ops:.4f} ms ops  [{card}]", flush=True)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
