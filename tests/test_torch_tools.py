"""The port's study tools (``mlmcpathintegral_tpu_torch/tools/``) against
the JAX package's tools, loaded from ``tools/`` by path, on the CPU:

* the scale study's ``run_mlmc`` and the screen-bias study's ``run_one``
  at 8x8, two levels, a few thousand samples (the port in f64 on its
  unfused path; the JAX tools unfused, in their own f32): the same keys in
  the same order, the same oracle to 1e-12, both estimates within 4 sigma
  of it;
* the two-level kernel's plain version, the card's oracle for its block
  branch, against the Pallas kernel in interpret mode at a 32x32 fine
  field (the scale study's 32x32 row, beta = 16: 4 chains, 2 steps, t_sub
  2) to the 8x8 test's 1e-9;
* ``analyze_qoi_log`` against the JAX tool's Python path on one log;
* ``test_distribution``'s file against the JAX tool's format, the density
  column within 1e-10, for every distribution; the fill-in tool's
  densities against the JAX distributions';
* the chain-scaling table's columns, and one mesh row over two gloo
  ranks."""

import contextlib
import importlib.util
import io
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops import pallas_schwinger_twolevel as jtl
from mlmcpathintegral_tpu_torch.ops import schwinger as tsw
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as ttl
from mlmcpathintegral_tpu_torch.tools import (
    analyze_qoi_log, plot_schwinger_fillin_distribution, scaling_study,
    schwinger_scale_study, screen_bias_study, test_distribution,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_tool(name):
    """A module of the JAX package's ``tools/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within(row, sigmas=4.0):
    return abs(row["chit"] - row["oracle"]) < sigmas * row["err"]


def test_scale_study_row_matches_the_jax_tool():
    # the screen-bias study's chains, chunk and window: the JAX tools'
    # persistent compilation cache then serves the second test's programs
    kw = dict(beta=4.0, n_level=2, n_samples=1024, n_chains=32,
              chunk_size=16, use_pallas=False, n_autocorr_window=64)
    want = _jax_tool("schwinger_scale_study").run_mlmc(8, 8, **kw)
    got = schwinger_scale_study.run_mlmc(8, 8, device="cpu",
                                         dtype=torch.float64, **kw)
    assert list(got) == list(want)
    assert got["oracle"] == pytest.approx(want["oracle"], abs=1e-12)
    assert got["n_samples_level0"] == want["n_samples_level0"] == 1024
    assert _within(got) and _within(want), (got, want)
    assert got["n_recorded"] == want["n_recorded"] == "1024/1024"


def test_screen_bias_row_matches_the_jax_tool(monkeypatch):
    import mlmcpathintegral_tpu.mc as jmc

    class Unfused(jmc.MonteCarloMultiLevel):
        def __init__(self, *a, **kw):
            kw.update(use_pallas=False, pallas_interpret=False)
            super().__init__(*a, **kw)

    # the JAX tool always asks for the fused kernels; on the CPU its
    # unfused path stands in for them, as the port's does here
    monkeypatch.setattr(jmc, "MonteCarloMultiLevel", Unfused)
    kw = dict(rel_target=0.05, n_chains=32, chunk_size=16)
    want = _jax_tool("screen_bias_study").run_one(8, 4.0, 1, **kw)
    got = screen_bias_study.run_one(8, 4.0, 1, use_pallas=False,
                                    device="cpu", dtype=torch.float64, **kw)
    assert list(got) == list(want)
    assert got["oracle"] == pytest.approx(want["oracle"], abs=1e-12)
    assert _within(got) and _within(want), (got, want)


def test_twolevel_plain_matches_pallas_at_32x32():
    """The block branch's oracle at the scale study's 32x32 launch: a
    coarse field equilibrated by the plain sweep at the row's beta_c and
    filled by the conditioned action (both held to JAX's by their own
    tests), then 2 steps of the kernel."""
    M, C, beta = 32, 4, 16.0
    mc = schwinger_scale_study.make_mlmc(M, M, beta=beta)
    act, beta_c = mc.actions[0], mc.actions[1].beta
    cond = mc.twolevel_steps[0].conditioned_fine_action
    coarse = tsw.schwinger_sweep_chain(
        torch.from_numpy(np.random.default_rng(5).uniform(
            -np.pi, np.pi, (C, M * M // 2))),
        (3, 4), beta=beta_c, Mt=M // 2, Mx=M // 2, n_steps=8)[0]
    gen = torch.Generator().manual_seed(9)
    fine = cond.fill_fine_points(gen, act.prolongate(
        coarse, act.initialise_state(gen, C, torch.float64, "cpu")))
    fine, coarse, sf, sq = (t.numpy().copy() for t in (
        fine, coarse, act.evaluate(fine), cond.evaluate(fine)))
    seed = np.array([5, -6], np.int32)
    kw = dict(beta=beta, beta_c=beta_c, Mt=M, Mx=M, n_steps=2, t_sub=2,
              k_rej_bessel=16)
    want = jtl.schwinger_twolevel_chain(
        *[jnp.asarray(a) for a in (fine, coarse, sf, sq)],
        jnp.asarray(seed), block_chains=C, interpret=True, **kw)
    got = ttl.schwinger_twolevel_chain(
        *[torch.from_numpy(a) for a in (fine, coarse, sf, sq)],
        torch.from_numpy(seed), **kw)
    for name, g, w in zip(("theta_fine", "theta_coarse", "S_fine", "S_cond",
                           "y", "qc", "ec", "acc"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert float(got[7].sum()) > 0, "no proposal accepted"


def test_analyze_qoi_log_matches_the_jax_tools_python_path(tmp_path,
                                                           monkeypatch):
    rs = np.random.default_rng(11)
    T, C, rho = 600, 3, 0.8
    x = np.empty((T, C))
    x[0] = rs.normal(size=C)
    for i in range(1, T):
        x[i] = rho * x[i - 1] + rs.normal(size=C) * math.sqrt(1 - rho ** 2)
    log = tmp_path / "qoi.bin"
    x.tofile(log)
    from mlmcpathintegral_tpu.utils import native
    monkeypatch.setattr(native, "_load", lambda: None)
    jtool = _jax_tool("analyze_qoi_log")
    monkeypatch.setattr(sys, "argv", ["analyze_qoi_log", str(log),
                                      "--n-chains", str(C)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jtool.main()
    want = buf.getvalue().splitlines()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze_qoi_log.main([str(log), "--n-chains", str(C)])
    assert buf.getvalue().splitlines() == want


def _read_distribution(path):
    head, samples, density, section = [], [], [], None
    for line in Path(path).read_text().splitlines():
        if line.startswith("# === samples"):
            section = samples
        elif line.startswith("# === density"):
            section = density
        elif line.startswith("#"):
            head.append(line)
        else:
            section.append([float(v) for v in line.split()])
    return head, np.asarray(samples), np.asarray(density)


@pytest.mark.parametrize("name,extra", [
    ("expsin2", ["--sigma=4.0"]), ("expcos", []), ("compactexp", []),
    ("besselproduct", []), ("approximatebesselproduct", ["--beta=16.0"])])
def test_distribution_file_matches_the_jax_tools_format(tmp_path,
                                                        monkeypatch, name,
                                                        extra):
    args = [f"--distribution={name}", "--n-samples=500"] + extra
    jtool = _jax_tool("test_distribution")
    monkeypatch.setattr(sys, "argv", ["test_distribution", *args,
                                      f"--output={tmp_path}/jax.txt"])
    with contextlib.redirect_stdout(io.StringIO()):
        jtool.main()
        test_distribution.main(args + [f"--output={tmp_path}/port.txt",
                                       "--device=cpu"])
    jh, js, jd = _read_distribution(tmp_path / "jax.txt")
    th, ts, td = _read_distribution(tmp_path / "port.txt")
    assert th == jh
    assert ts.shape == js.shape == (500, 1)
    np.testing.assert_array_equal(td[:, 0], jd[:, 0])
    np.testing.assert_allclose(td[:, 1], jd[:, 1], rtol=0, atol=1e-10)
    lo, hi = jd[0, 0], jd[-1, 0]
    assert np.all((ts >= lo) & (ts <= hi))


def test_fillin_data_densities_match_jax():
    from mlmcpathintegral_tpu.distributions.approxbesselproduct import (
        ApproximateBesselProductDistribution as JApprox,
    )
    from mlmcpathintegral_tpu.distributions.besselproduct import (
        BesselProductDistribution as JBessel,
    )
    d = plot_schwinger_fillin_distribution.fillin_data(beta=4.0, n=200,
                                                       device="cpu")
    xs = jnp.asarray(d["xs"])
    for key, D in (("p_approx", JApprox(4.0)), ("p_exact", JBessel(4.0))):
        np.testing.assert_allclose(d[key], np.asarray(D.evaluate(
            xs, 0.5, -0.3)), rtol=1e-12, atol=1e-12, err_msg=key)
    assert d["x_exact"].shape == d["x_approx"].shape == (200,)
    assert "x_exact" not in plot_schwinger_fillin_distribution.fillin_data(
        beta=16.0, n=10, device="cpu")


def test_chain_scaling_table_has_the_jax_tools_columns():
    rows, layouts = scaling_study.run_chain_scaling(
        chain_counts=(4, 8), n_steps=2, reps=1, device="cpu")
    assert list(rows[0]) == [
        "n_chains", "twolevel_samples_per_sec", "twolevel_us_per_sample",
        "sweep_link_updates_per_sec", "sweep_wall_s", "throughput_vs_peak",
        "saturated"]
    assert layouts == {}
    assert max(r["throughput_vs_peak"] for r in rows) == 1.0


def test_mesh_row_runs_on_two_gloo_ranks():
    wall = scaling_study.mesh_wall(2, n_chains=8, n_samples=64,
                                   chunk_size=8, timeout_s=240.0)
    assert 0.0 < wall < 240.0
