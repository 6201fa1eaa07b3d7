"""The window drives the chunks that ``evaluate`` drives: on a tiny
lattice on the CPU, set-up plus N rounds fed the chunk seeds that
``evaluate`` would draw end where ``evaluate`` run to the same per-level
target ends, and record the same Y."""

import math

import numpy as np
import torch

from perfbench import drive, harness

from conftest import TINY

N_ROUNDS = 3


def test_window_equals_evaluate(tiny_root):
    _, cfg, traffic, _, _ = harness.load_cell(TINY, tiny_root)
    C, f32, cpu = traffic["chains"], torch.float32, torch.device("cpu")

    mc = drive.make_mlmc(cfg, n_samples=C)
    gen, carries = drive.set_up(mc, 11, C, f32, cpu)
    levels = drive.levels(mc)
    L = len(levels)
    chunk = levels[0]["chunk"]
    assert all(lv["chunk"] == chunk for lv in levels)
    for lv in levels:
        lv.update(span_s=0.0, dispatch_s=0.0, launches=0)
    # evaluate's fixed pass draws level L-1's chunks first, then L-2's
    seeds = [harness.chunk_seed(gen) for _ in range(L * N_ROUNDS)]

    def seed_for(r, ell):
        return seeds[(L - 1 - ell) * N_ROUNDS + r]

    tap = harness.Tap()
    fns = drive.chunk_functions(mc, tap.wrap)
    rounds, _, kept = harness.run_window(
        drive, mc, fns, carries, levels, chunk, seed_for,
        np.random.default_rng(0), tap, cpu, max_rounds=N_ROUNDS)
    assert rounds == N_ROUNDS and set(kept) == set(range(L))

    ref = drive.make_mlmc(cfg, n_samples=(1 + N_ROUNDS) * chunk * C)
    _, ref_carries = drive.set_up(ref, 11, C, f32, cpu)
    for ell in range(L):
        a = torch.utils._pytree.tree_leaves(carries[ell])
        b = torch.utils._pytree.tree_leaves(ref_carries[ell])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        # the samples since burn-in: the probe's chunk and the rounds
        assert int(drive.y_stats(mc, ell, carries[ell]).n) \
            == (1 + N_ROUNDS) * chunk


def test_fresh_y_counts_the_window_alone(tiny_root):
    _, cfg, traffic, _, _ = harness.load_cell(TINY, tiny_root)
    C, f32, cpu = traffic["chains"], torch.float32, torch.device("cpu")
    mc = drive.make_mlmc(cfg, n_samples=C)
    _, carries = drive.set_up(mc, 12, C, f32, cpu)
    levels = drive.levels(mc)
    for lv in levels:
        lv.update(span_s=0.0, dispatch_s=0.0, launches=0)
    carries = [drive.with_fresh_y(mc, ell, c, C, f32, cpu)
               for ell, c in enumerate(carries)]
    tap = harness.Tap()
    fns = drive.chunk_functions(mc, tap.wrap)
    chunk = levels[0]["chunk"]
    gen = torch.Generator().manual_seed(1)
    harness.run_window(drive, mc, fns, carries, levels, chunk,
                       lambda r, ell: harness.chunk_seed(gen),
                       np.random.default_rng(1), tap, cpu, max_rounds=2)
    for ell, lv in enumerate(levels):
        assert int(drive.y_stats(mc, ell, carries[ell]).n_lt) == 2 * chunk
        assert lv["launches"] == 2
        assert math.isfinite(lv["span_s"])
