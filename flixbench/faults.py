"""Faults planted in the program, under the functions the runs call, for
the control and for the tests that see the check fail.

  control          reads compare keys at float32 precision (a 24-bit
                   significand): the keys of POINT, SUCCESSOR and RANGE ops
                   are rounded to float32 before the batch is sorted.  It
                   breaks the configurations' first guarantee, exact 32-bit
                   keys.
  unchanged_state  a batch's answers are right but its state is dropped:
                   the engine hands back the state it was given
  half_batch       every other op of the sorted batch is left out: never
                   applied, and its answers the defaults of an op that
                   reads nothing
  altered_answer   one answer altered where it is produced: the first
                   POINT op's value of every batch plus one

``install(name)`` patches ``make_ops`` or ``apply_ops_safe`` where the
runs look them up (``repro_torch.core``) and returns the function that
undoes it.
"""

from __future__ import annotations

import importlib

import torch

from flixbench import opcodes



def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.int64).clamp(max=opcodes.MAX_VALID).to(x.dtype)


def _control(real):
    def make_ops(tags, keys, vals=None, **kw):
        tags, keys = torch.as_tensor(tags), torch.as_tensor(keys)
        reads = (tags == opcodes.POINT) | (tags == opcodes.SUCCESSOR) | (tags == opcodes.RANGE)
        keys = torch.where(reads, _f32(keys), keys)
        if vals is not None:
            vals = torch.as_tensor(vals)
            vals = torch.where(tags == opcodes.RANGE, _f32(vals), vals)
        return real(tags, keys, vals, **kw)
    return make_ops


def _unchanged(real):
    def apply(state, ops, **kw):
        _, results, stats = real(state, ops, **kw)
        return state, results, stats
    return apply


def _half(real):
    def apply(state, ops, **kw):
        from repro_torch.core import OpBatch

        out = torch.arange(ops.size, device=ops.key.device) % 2 == 1
        kept = OpBatch(tag=torch.where(out, opcodes.POINT, ops.tag), key=ops.key,
                       val=ops.val, exp=ops.exp)
        new, results, stats = real(state, kept, **kw)
        results = dict(results)
        for k, blank in (("value", opcodes.NOT_FOUND), ("succ_key", opcodes.EMPTY),
                         ("range_start", 0), ("range_count", 0)):
            results[k] = torch.where(out, blank, results[k])
        return new, results, stats
    return apply


def _altered(real):
    def apply(state, ops, **kw):
        new, results, stats = real(state, ops, **kw)
        points = torch.nonzero(ops.tag == opcodes.POINT)[:, 0]
        if points.numel():
            results = dict(results)
            results["value"] = results["value"].clone()
            results["value"][points[0]] += 1
        return new, results, stats
    return apply


FAULTS = {
    "control": {"make_ops": _control},
    "unchanged_state": {"apply_ops_safe": _unchanged},
    "half_batch": {"apply_ops_safe": _half},
    "altered_answer": {"apply_ops_safe": _altered},
}


def install(name: str):
    patched = []
    mod = importlib.import_module("repro_torch.core")
    for fn, wrap in FAULTS[name].items():
        real = getattr(mod, fn)
        setattr(mod, fn, wrap(real))
        patched.append((mod, fn, real))

    def undo():
        for mod, fn, real in patched:
            setattr(mod, fn, real)
    return undo
