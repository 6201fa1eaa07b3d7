"""The fused path: every level on the program's fused kernels, K4 on a
fine level and K3 on the coarsest.  A configuration that names no
``path`` runs it.

Its program calls are ``drive.py``'s, its check is ``check.judge``.  Its
``chunk_functions`` pass each level's kernel (K4 or K3) to the harness's
``wrap(ell, kind, kernel)``, so the tap keeps that kernel call's inputs
and outputs, and a control or a fault replaces the kernel.  Its
``hooks`` plant them (``control.py``):

* ``control``: the reference in bfloat16 in the kernels' place, and the
  reference's statistics update in bfloat16;
* ``unchanged``: the kernel returns its input state unchanged (and the
  traces the state gives);
* ``half``: the kernel runs the first half of the chains, and the second
  half repeats it, so every mean is the first half's;
* ``altered``: Y is altered where the kernel produces it (+1e-2);
* ``lagged``: the statistics update drops the lagged products.
"""

import torch

from perfbench import control
from perfbench.check import judge  # noqa: F401
from perfbench.drive import (  # noqa: F401
    chunk_functions, levels, make_mlmc, set_up, timings, with_fresh_y,
    y_stats,
)
from perfbench.reference import schwinger as ref

#: the chain axis of each output of K4 (fine, coarse, S_fine, S_cond, Y,
#: qc, ec, accept) and of K3 (links, Q, energy)
CHAIN_DIM = {"k4": (0, 0, 0, 0, 1, 1, 1, 1), "k3": (0, 1, 1)}
KERNEL_MODES = ("control", "unchanged", "half", "altered")


def _reference_kernel(kind, dtype):
    """The reference in ``dtype`` in a kernel's place: float32 in and out,
    as the kernel takes and gives."""
    fn = ref.twolevel_chain if kind == "k4" else ref.sweep_chain

    def kernel(*args, **kw):
        args = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        return tuple(o.to(torch.float32) for o in fn(*args, **kw))
    return kernel


def _faulty_kernel(kind, kernel, mode):
    def broken(*args, **kw):
        out = list(kernel(*args, **kw))
        if mode == "unchanged":
            # the state comes back as it went in: K4 (fine, coarse, S_f,
            # S_q), K3 (links); the traces are left as the kernel gave them
            n_state = 4 if kind == "k4" else 1
            out[:n_state] = [a.clone() for a in args[:n_state]]
        elif mode == "half":
            for i, o in enumerate(out):
                dim = CHAIN_DIM[kind][i]
                h = o.shape[dim] // 2
                idx = torch.arange(o.shape[dim], device=o.device) % h
                out[i] = o.index_select(dim, idx)
        elif mode == "altered":
            if kind == "k4":
                out[4] = out[4] + 1e-2
            else:
                out[1] = out[1] + 1e-2
        return tuple(out)
    return broken


def hooks(mode: str):
    """``run_cell``'s ``wrap`` and ``record`` for a control or fault mode;
    None for a mode this path cannot plant."""
    if mode == "lagged":
        return {"record": control.dropped_lags}
    if mode not in KERNEL_MODES:
        return None

    def wrap(tap):
        def make(ell, kind, kernel):
            if mode == "control":
                k = _reference_kernel(kind, torch.bfloat16)
            else:
                k = _faulty_kernel(kind, kernel, mode)
            return tap.wrap(ell, kind, k)
        return make
    if mode == "control":
        return {"wrap": wrap,
                "record": control.reference_record(torch.bfloat16)}
    return {"wrap": wrap}
