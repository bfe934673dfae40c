"""Named spans at the phase boundaries of the training step and the
scheduler step, recorded only while a ``torch.profiler`` records.

``with span("train.forward"):`` is a ``torch.profiler.record_function``
range while a profiler is recording on this thread, so the span lands in
the profiler's trace beside the torch ops and the device's kernels, on the
clock the profiler aligns them to.  Otherwise it is one shared no-op
context, after a single check of the profiler's state: there is no setting
to turn spans on, and no other store of them.

Keyword arguments become the range's ``args`` string (``"B=8 K=16"``),
formatted only while recording.  ``add_to=(obj, "attr")`` also adds the
span's wall time, in seconds, to the float ``obj.attr`` whether or not a
profiler records: a counter and its span are one ``with`` statement.
"""

from __future__ import annotations

import contextlib
import time

import torch

_NOOP = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str, *, add_to=None, **args):
    """A context over one phase; see the module's docstring."""
    if add_to is None:
        if not recording():
            return _NOOP
        return _range(name, args)
    return _Timed(add_to, _range(name, args) if recording() else None)


def _range(name: str, args: dict):
    return torch.profiler.record_function(
        name, " ".join(f"{k}={v}" for k, v in args.items()) or None)


class _Timed:
    """Adds the wall time of the ``with`` block to ``owner.attr``, inside a
    profiler range when one is given."""

    __slots__ = ("owner", "attr", "rng", "t0")

    def __init__(self, add_to, rng):
        self.owner, self.attr = add_to
        self.rng = rng

    def __enter__(self):
        if self.rng is not None:
            self.rng.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, getattr(self.owner, self.attr)
                + time.monotonic() - self.t0)
        if self.rng is not None:
            self.rng.__exit__(*exc)
        return False
