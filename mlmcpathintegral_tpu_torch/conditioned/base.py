"""Conditioned fine action interface (PyTorch port of
``mlmcpathintegral_tpu/conditioned/base.py``; reference
src/action/conditionedfineaction.hh:38-67).

Given a state whose coarse dofs are set, a ConditionedFineAction fills the
fine-only dofs by sampling from an approximate conditional
q(fine | coarse), and evaluates -log q(fine | coarse) including the
normalisation — a mismatch between the two biases the two-level accept
ratio.  Both operations are batched over chains.
"""

from __future__ import annotations

import abc


class ConditionedFineAction(abc.ABC):

    #: True when prolongate + fill_fine_points overwrite every dof with
    #: values set by the coarse dofs and fresh noise alone, never reading a
    #: fine dof of the template state.  It licenses the batched
    #: delayed-acceptance screen (mc/twolevel.py make_batched_screen),
    #: which draws a whole chunk of proposals at once.  A fill that reads
    #: fine dofs of the current state must set it False.
    independent_fill = True

    def __init__(self, action):
        #: fine-level action this conditions on
        self.action = action

    @abc.abstractmethod
    def fill_fine_points(self, generator, x):
        """Sample the fine-only dofs of x given its coarse dofs; returns a
        full state [..., ndof]."""

    @abc.abstractmethod
    def evaluate(self, x):
        """-log q(fine | coarse) incl. normalisation: [..., ndof] -> [...]."""
