"""The port's simulation engines and the paper's analytic half against the
reference, on the CPU.

Twins of tests/test_core_theory.py, test_vector_sim.py and
test_paper_claims.py at their small sizes: the error model (Eq. 1/10),
the switching times (Thm. 2), Thm. 5's quadruple sum, the generalized
model's moment fit and the analytic schedule equal ``repro.core``'s
within 1e-12 relative (the same float operations in the same order);
the scalar ``simulate`` (a numpy copy, the oracle) equals the
reference's exactly; and ``simulate_batch``, whose lane state is torch
tensors (here on the CPU), gives the reference's stage logs and the
port's scalar lanes' exactly and their trajectories within 1e-9
relative (the batched gradient sums in another order).
"""

import math

import numpy as np
import pytest

import repro.core as J
import repro.core.error_model as jem
import repro.core.order_stats as jos
import repro.core.simulation as jsim
import repro_torch.core as P
import repro_torch.core.error_model as pem
import repro_torch.core.order_stats as pos
import repro_torch.core.simulation as psim

GRID = (0.2, 0.4, 0.6, 0.8, 1.0)
N, S = 10, 10
STRATEGIES = ("naive", "fastest_k", "adaptive_k", "adaptive_kbeta")
REL = 1e-12
TRAJ = 1e-9


def _models(core):
    return {
        "simplified": core.SimplifiedDelayModel(lambda_y=1.0, x=0.01),
        "generalized": core.GeneralizedDelayModel(lambda_x=2.0, lambda_y=1.0, x=0.01),
    }


def _problem(core, **kw):
    return core.LinregProblem.generate(v=N * S, d=10, n_workers=N, seed=1, **kw)


def _cfg(core, strategy, **kw):
    args = dict(n=N, s=S, k_max=5, k0=2, beta0=0.4 if strategy == "fastest_k" else None,
                beta_grid=GRID)
    args.update(kw)
    return core.StrategyConfig(strategy, **args)


def _log(log):
    return [(i, st.k, st.beta) for i, st in log]


def _same_floats(a, b, rel=REL):
    assert math.isclose(a, b, rel_tol=rel, abs_tol=0.0) or (a == b), (a, b)


# --- the analytic half --------------------------------------------------------


def _hp(core, **kw):
    args = dict(eta=0.01, L=2.0, sigma_grad2=10.0, c=1.0, s=20)
    args.update(kw)
    return core.SGDHyperParams(**args)


@pytest.mark.parametrize("phi", [0.2, 1.0, 3.5, 10.0])
def test_error_model_matches_reference(phi):
    jh, ph = _hp(J), _hp(P)
    _same_floats(pem.alpha(ph), jem.alpha(jh))
    _same_floats(P.error_floor(ph, phi), J.error_floor(jh, phi))
    for e0, iters in ((10.0, 0.0), (10.0, 37.5), (0.5, 1e4), (1e-4, 3.0)):
        _same_floats(P.error_after(ph, phi, e0, iters), J.error_after(jh, phi, e0, iters))
    for mu, e0, target in ((0.7, 10.0, 1e-2), (2.0, 1.0, 0.9), (0.3, 1e-3, 1e-2),
                           (1.0, 10.0, 1e-9)):
        a, b = P.time_to_error(ph, phi, mu, e0, target), J.time_to_error(jh, phi, mu, e0, target)
        assert (math.isinf(a) and math.isinf(b)) or math.isclose(a, b, rel_tol=REL), (a, b)
    with pytest.raises(ValueError, match="contraction"):
        P.SGDHyperParams(eta=2.0, L=1.0, sigma_grad2=1.0, c=1.0, s=1)
    with pytest.raises(ValueError, match="phi"):
        P.error_floor(ph, 0.0)


@pytest.mark.parametrize("case", [
    dict(phi_cur=1.0, mu_cur=0.5, phi_next=2.0, mu_next=0.8, gap_start=5.0),
    dict(phi_cur=1.0, mu_cur=0.5, phi_next=2.0, mu_next=0.4, gap_start=5.0),   # dominates
    dict(phi_cur=1.0, mu_cur=0.5, phi_next=2.0, mu_next=0.8, gap_start=1e-4),  # at floor
    dict(phi_cur=0.4, mu_cur=0.3, phi_next=0.6, mu_next=0.31, gap_start=0.2),
])
def test_switching_matches_reference(case):
    jh, ph = _hp(J), _hp(P)
    dt_j, dt_p = J.switching_interval(jh, **case), P.switching_interval(ph, **case)
    _same_floats(dt_p, dt_j)
    g = dict(phi_cur=case["phi_cur"], mu_cur=case["mu_cur"], gap_start=case["gap_start"])
    for dt in (0.0, dt_j, 3.0):
        _same_floats(P.gap_at_switch(ph, dt=dt, **g), J.gap_at_switch(jh, dt=dt, **g))
    with pytest.raises(ValueError, match="grow phi"):
        P.switching_interval(ph, **{**case, "phi_next": case["phi_cur"]})


@pytest.mark.parametrize("n,k,beta", [(4, 1, 1.0), (6, 3, 0.6), (8, 8, 0.25), (10, 4, 0.8)])
def test_thm5_quadruple_sum_matches_reference(n, k, beta):
    jm = J.GeneralizedDelayModel(lambda_x=2.0, lambda_y=1.0, x=0.01, y=0.02)
    pm = P.GeneralizedDelayModel(lambda_x=2.0, lambda_y=1.0, x=0.01, y=0.02)
    _same_floats(pos.thm5_quadruple_sum(pm, n, k, beta), jos.thm5_quadruple_sum(jm, n, k, beta))
    # And the quadrature it cross-checks, as the reference's test does.
    assert pos.thm5_quadruple_sum(pm, n, k, beta) == pytest.approx(
        P.expected_kth(pm, n, k, beta), rel=1e-6)
    with pytest.raises(ValueError, match="lambda_x"):
        pos.thm5_quadruple_sum(P.GeneralizedDelayModel(lambda_x=1.0, lambda_y=1.0), 4, 2, 1.0)


@pytest.mark.parametrize("loads", [(1.0,), (0.25, 0.5, 1.0)])
def test_fit_generalized_mm_matches_reference(loads):
    rng = np.random.default_rng(3)
    betas = np.repeat(np.asarray(loads), 400)
    z = 0.05 + 0.1 * betas + rng.exponential(1 / 3.0, betas.size) \
        + betas * rng.exponential(1.0, betas.size)
    a = P.fit_generalized_mm(z, betas, x_shift=0.05, y_shift=0.1)
    b = J.fit_generalized_mm(z, betas, x_shift=0.05, y_shift=0.1)
    for f in ("lambda_x", "lambda_y", "x", "y"):
        _same_floats(getattr(a, f), getattr(b, f))


def _paper_setting(core):
    """tests/test_paper_claims.py's calibration: the Fig. 4 problem and the
    hyper-parameters that put the 2e-2 readout ~1.4x above the floor."""
    problem = core.LinregProblem.generate(v=400, d=10, n_workers=20, seed=1)
    model = core.SimplifiedDelayModel(lambda_y=1.0, x=0.01)
    lam = np.linalg.eigvalsh(2.0 * problem.X.T @ problem.X / problem.v)
    c = float(2.0 * lam.min())
    fl1 = 0.1846 * problem.eta / 9.284e-6
    hp = core.SGDHyperParams(eta=problem.eta, L=2.0,
                             sigma_grad2=fl1 * 2 * c * problem.s / (problem.eta * 2.0),
                             c=c, s=problem.s)
    return problem, model, hp, problem.gap(np.zeros(problem.d))


def _records(res):
    return [(r.k, r.beta, r.t_start, r.t_end, r.iters, r.gap_start, r.gap_end, r.mu)
            for r in res.stages]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_evaluate_schedule_matches_reference(strategy):
    """The analytic roll-out at the paper's Fig. 4 calibration, and the
    Fig. 1 grid point where computation dominates: every stage record and
    the totals within 1e-12 relative."""
    settings = [(_paper_setting(J), _paper_setting(P), dict(n=20, s=20, k_max=10), 2e-2)]
    for lam, x in ((0.5, 0.01), (5.0, 1.0)):
        settings.append(((None, J.SimplifiedDelayModel(lambda_y=lam, x=x), _hp(J), 10.0),
                         (None, P.SimplifiedDelayModel(lambda_y=lam, x=x), _hp(P), 10.0),
                         dict(n=50, s=20), 1e-3))
    for (_, jm, jh, e0), (_, pm, ph, _), kw, target in settings:
        extra = dict(k0=4) if strategy == "fastest_k" else {}
        jc = J.StrategyConfig(strategy, beta_grid=GRID, **kw, **extra)
        pc = P.StrategyConfig(strategy, beta_grid=GRID, **kw, **extra)
        a = P.evaluate_schedule(pc, pm, ph, e0=e0, target=target)
        b = J.evaluate_schedule(jc, jm, jh, e0=e0, target=target)
        assert (a.reached, a.n_stages) == (b.reached, b.n_stages)
        for x, y in zip([a.runtime, a.comp_cost, a.comm_cost], [b.runtime, b.comp_cost,
                                                                 b.comm_cost]):
            assert (math.isinf(x) and math.isinf(y)) or math.isclose(x, y, rel_tol=REL)
        for ra, rb in zip(_records(a), _records(b)):
            for x, y in zip(ra, rb):
                _same_floats(x, y)
    assert P.evaluate_schedule(pc, pm, ph, e0=1.0, target=2.0).runtime == 0.0


def test_paper_calibration_ratios_match_reference():
    """The analytic schedule's readout at that calibration, ours vs
    adaptive-k: runtime ratio, computation saved, communication added."""
    out = {}
    for core in (J, P):
        _, model, hp, e0 = _paper_setting(core)
        res = {s: core.evaluate_schedule(core.StrategyConfig(s, n=20, s=20, k_max=10,
                                                             beta_grid=GRID),
                                         model, hp, e0=e0, target=2e-2)
               for s in ("adaptive_kbeta", "adaptive_k")}
        ours, ak = res["adaptive_kbeta"], res["adaptive_k"]
        out[core.__name__] = (ours.runtime / ak.runtime, 1 - ours.comp_cost / ak.comp_cost,
                              ours.comm_cost / ak.comm_cost - 1)
    a, b = out["repro_torch.core"], out["repro.core"]
    for x, y in zip(a, b):
        _same_floats(x, y)
    # The bands of tests/test_paper_claims.py (the paper: ~0.5, -59.9 %, +15.7 %).
    assert 0.40 <= a[0] <= 0.70 and 0.45 <= a[1] <= 0.75 and 0.0 <= a[2] <= 0.30, a


# --- the scalar engine ----------------------------------------------------------


def _sim_equal(a, b):
    for f in ("times", "gaps", "comp_at_eval", "comm_at_eval"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.runtime, a.comp_cost, a.comm_cost, a.iterations, a.reached) == \
        (b.runtime, b.comp_cost, b.comm_cost, b.iterations, b.reached)
    assert _log(a.stage_log) == _log(b.stage_log)


@pytest.mark.parametrize("model_name", ["simplified", "generalized"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scalar_simulate_equals_reference(strategy, model_name):
    jp, pp = _problem(J), _problem(P)
    jm, pm = _models(J)[model_name], _models(P)[model_name]
    a = P.simulate(pp, _cfg(P, strategy), pm, seed=2, max_iters=800, eval_every=7)
    b = J.simulate(jp, _cfg(J, strategy), jm, seed=2, max_iters=800, eval_every=7)
    _sim_equal(a, b)


@pytest.mark.parametrize("mode", ["oracle", "estimate", "target"])
def test_scalar_simulate_options_equal_reference(mode):
    jp, pp = _problem(J), _problem(P)
    jm, pm = _models(J)["simplified"], _models(P)["simplified"]
    kw = dict(seed=1, max_iters=1000, eval_every=10)
    if mode == "oracle":
        kw["oracle_switch_times"] = [2.0, 4.0, 5.5, 8.0]
    elif mode == "estimate":
        kw["estimate_model"] = True
        kw["w0"] = np.full(jp.d, 0.01)
    else:
        kw["target_gap"] = 0.05 * jp.gap(np.zeros(jp.d))
    a = P.simulate(pp, _cfg(P, "adaptive_kbeta"), pm, **kw)
    b = J.simulate(jp, _cfg(J, "adaptive_kbeta"), jm, **kw)
    _sim_equal(a, b)
    if mode == "oracle":
        assert len(a.stage_log) > 1
    if mode == "target":
        assert a.reached and a.iterations < 1000
        assert a.time_to_gap(kw["target_gap"]) == b.time_to_gap(kw["target_gap"])
        assert a.cost_at_gap(kw["target_gap"]) == b.cost_at_gap(kw["target_gap"])


def test_lane_rng_layout_equals_reference():
    """The per-lane two-stream layout both engines draw from."""
    assert psim.chunk_len(20, 20) == jsim.chunk_len(20, 20)
    assert psim.chunk_len(3, 2) == jsim.chunk_len(3, 2)
    jm, pm = _models(J)["generalized"], _models(P)["generalized"]
    for seed in (0, 7):
        (jz, ju), (pz, pu) = jsim.spawn_lane_rngs(seed), psim.spawn_lane_rngs(seed)
        np.testing.assert_array_equal(psim.draw_response_chunk(pz, pm, 6, 9),
                                      jsim.draw_response_chunk(jz, jm, 6, 9))
        np.testing.assert_array_equal(psim.draw_key_chunk(pu, 6, 5, 9),
                                      jsim.draw_key_chunk(ju, 6, 5, 9))


# --- the batched engine (lanes in torch tensors, here on the CPU) ---------------


def _batch_pair(strategy, model_name="simplified", problem_kw=None, cfg_kw=None, **kw):
    jp, pp = _problem(J, **(problem_kw or {})), _problem(P, **(problem_kw or {}))
    jm, pm = _models(J)[model_name], _models(P)[model_name]
    jc, pc = _cfg(J, strategy, **(cfg_kw or {})), _cfg(P, strategy, **(cfg_kw or {}))
    b = J.simulate_batch(jp, jc, jm, **kw)
    a = P.simulate_batch(pp, pc, pm, device="cpu", **kw)
    return a, b, (pp, pc, pm)


def _hold_batch(a, b, scalar_args=None, sim_kw=None):
    """Stage logs, iterations, reached and eval counts equal; times and
    costs bit for bit (the same additions of the same draws); gaps within
    ``TRAJ`` relative; each lane equal to the port's scalar run."""
    assert a.seeds == b.seeds
    assert [_log(x) for x in a.stage_logs] == [_log(x) for x in b.stage_logs]
    for f in ("n_evals", "iterations", "reached", "times", "comp_at_eval", "comm_at_eval",
              "runtime", "comp_cost", "comm_cost"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_allclose(a.gaps, b.gaps, rtol=TRAJ, atol=0)
    if scalar_args is None:
        return
    pp, pc, pm = scalar_args
    for i, seed in enumerate(a.seeds):
        sc = P.simulate(pp, pc, pm, seed=seed, **sim_kw)
        lane = a.lane(i)
        assert _log(lane.stage_log) == _log(sc.stage_log), seed
        assert (lane.iterations, lane.reached) == (sc.iterations, sc.reached)
        np.testing.assert_array_equal(lane.times, sc.times)
        np.testing.assert_allclose(lane.gaps, sc.gaps, rtol=TRAJ, atol=0)


@pytest.mark.parametrize("model_name", ["simplified", "generalized"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batch_equals_reference_and_scalar_lanes(strategy, model_name):
    kw = dict(max_iters=1200, eval_every=10)
    a, b, args = _batch_pair(strategy, model_name, seeds=3, **kw)
    _hold_batch(a, b, args, kw)
    if strategy.startswith("adaptive"):
        assert any(len(log) > 1 for log in a.stage_logs)


@pytest.mark.parametrize("model_name", ["simplified", "generalized"])
def test_batch_oracle_switch_times_equal_reference(model_name):
    kw = dict(max_iters=1200, eval_every=10, oracle_switch_times=[2.0, 4.0, 5.5, 8.0, 11.0, 15.0])
    a, b, args = _batch_pair("adaptive_kbeta", model_name, seeds=3, **kw)
    _hold_batch(a, b, args, kw)
    assert len(a.stage_logs[0]) > 1


@pytest.mark.parametrize("kind", ["distance", "pflug", "loss"])
def test_batch_diagnostic_kinds_equal_reference(kind):
    kw = dict(max_iters=1000, eval_every=10)
    jp, pp = _problem(J), _problem(P)
    jc = J.StrategyConfig("adaptive_kbeta", n=N, s=S, k_max=5, beta_grid=GRID,
                          diagnostic=J.DiagnosticConfig(kind=kind))
    pc = P.StrategyConfig("adaptive_kbeta", n=N, s=S, k_max=5, beta_grid=GRID,
                          diagnostic=P.DiagnosticConfig(kind=kind))
    jm, pm = _models(J)["simplified"], _models(P)["simplified"]
    a = P.simulate_batch(pp, pc, pm, seeds=2, device="cpu", **kw)
    b = J.simulate_batch(jp, jc, jm, seeds=2, **kw)
    _hold_batch(a, b, (pp, pc, pm), kw)
    if kind != "pflug":
        assert any(len(log) > 1 for log in a.stage_logs), kind


def test_batch_pflug_advancement_equals_reference():
    """Near the stability limit Pflug's statistic turns negative and drives
    the stage walk."""
    lam = float(np.linalg.eigvalsh(2.0 * _problem(J).X.T @ _problem(J).X / (N * S)).max())
    jp, pp = _problem(J, eta=1.2 / lam), _problem(P, eta=1.2 / lam)
    jc = J.StrategyConfig("adaptive_kbeta", n=N, s=S, k_max=5, beta_grid=GRID,
                          diagnostic=J.DiagnosticConfig(kind="pflug", burn_in=16))
    pc = P.StrategyConfig("adaptive_kbeta", n=N, s=S, k_max=5, beta_grid=GRID,
                          diagnostic=P.DiagnosticConfig(kind="pflug", burn_in=16))
    kw = dict(max_iters=600, eval_every=10)
    jm, pm = _models(J)["simplified"], _models(P)["simplified"]
    a = P.simulate_batch(pp, pc, pm, seeds=2, device="cpu", **kw)
    b = J.simulate_batch(jp, jc, jm, seeds=2, **kw)
    assert all(len(log) > 1 for log in a.stage_logs)
    _hold_batch(a, b, (pp, pc, pm), kw)


def test_batch_target_gap_early_exit_equals_reference():
    target = 0.05 * _problem(J).gap(np.zeros(10))
    kw = dict(max_iters=3000, eval_every=10, target_gap=target)
    a, b, args = _batch_pair("adaptive_kbeta", seeds=4, **kw)
    assert a.reached.all()
    _hold_batch(a, b, args, kw)
    assert a.times.shape[1] == int(a.n_evals.max())
    assert a.mean_time_to_gap(target) == b.mean_time_to_gap(target)


def test_batch_seed_sequence_and_w0_equal_reference():
    kw = dict(max_iters=400, eval_every=10)
    a, b, args = _batch_pair("adaptive_k", seeds=(7, 3), **kw)
    _hold_batch(a, b, args, kw)
    w0 = np.full(10, 0.1)
    kw = dict(max_iters=200, eval_every=10, w0=w0)
    a, b, args = _batch_pair("fastest_k", seeds=2, **kw)
    _hold_batch(a, b, args, kw)
    lanes = np.stack([w0, 2 * w0])
    a, b, _ = _batch_pair("naive", seeds=2, max_iters=50, eval_every=5, w0=lanes)
    _hold_batch(a, b)
    with pytest.raises(ValueError, match="broadcast"):
        _batch_pair("naive", seeds=3, max_iters=5, w0=lanes)


def test_batch_refusals_match_reference():
    pp, pm = _problem(P), _models(P)["simplified"]
    with pytest.raises(ValueError, match="estimate"):
        P.simulate_batch(pp, _cfg(P, "adaptive_kbeta"), pm, seeds=2, max_iters=10,
                         estimate_model=True, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        P.simulate_batch(pp, P.StrategyConfig("adaptive_k", n=N + 1, s=S, k_max=5), pm,
                         seeds=2, max_iters=10, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        P.simulate_batch(pp, _cfg(P, "naive"), pm, seeds=(), max_iters=10, device="cpu")
