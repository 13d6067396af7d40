"""Seconds a proof in the program's `commit.fixed` spans
(msm/fixed_base.py `commit_fixed`: one fixed-base commit, its bucket
accumulation, weighted reduction and Jacobian products), host clock,
summed over the window's proofs and divided by their number.  The span
does not synchronise: it holds the host's time to launch the commit,
which follows the device's while the launch queue is full.  None where
the program has no such span (a program without it, or a cell whose
commits all take the variable-base path)."""

from portbench.program_spans import round_s


def read(run):
    return round_s(run, "commit.fixed")
