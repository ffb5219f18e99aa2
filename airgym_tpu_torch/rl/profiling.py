"""Program spans on the profiler's clock.

``span(name)`` marks a phase of the program (``rl/ppo.PPO.train_epoch``'s
``epoch`` and its phases, the plain update's ``minibatch`` steps, the
fused rollout's ``bookkeeping``, ``ops/fused_hovering.rollout_fused``,
the image encoder's call ``encode`` in ``models/actor_critic``, and
``encode_hit``, a frozen encoder's head alone, beside it).
Between ``start()`` and ``stop()`` each span appends one ``Record`` to a
list in memory, stamped with ``time.time_ns()``: the clock that
``torch.profiler`` (kineto) stamps its host events with and converts the
device's timestamps to, so a reading of a profiled stretch places the
spans on the device timeline with no sync and no marker kernel. Tracing
never syncs the device. While it is off, ``span()`` tests one flag and
returns a shared null context: no clock read, no allocation, no CUDA
call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

_NULL = contextlib.nullcontext()
_on = False
_records: List["Record"] = []
_open: List[int] = []          # indices of the open spans, innermost last
_roots = 0                     # root spans opened since start()


@dataclasses.dataclass
class Record:
    """One span: ``parent`` is the index of the enclosing span's record
    (-1 for a root); ``root_id`` is shared by a root and every span under
    it (the epoch index, or the root's count since ``start()``); start
    and end are ``time.time_ns()`` (end None while the span is open)."""
    name: str
    parent: int
    root_id: int
    start_ns: int
    end_ns: Optional[int] = None


class _Span:
    __slots__ = ("name", "root_id", "records", "index")

    def __init__(self, name: str, root_id: Optional[int]):
        self.name, self.root_id = name, root_id

    def __enter__(self):
        global _roots
        if _open:
            parent = _open[-1]
            root_id = _records[parent].root_id
        else:
            parent = -1
            root_id = _roots if self.root_id is None else self.root_id
            _roots += 1
        self.records, self.index = _records, len(_records)
        _records.append(Record(self.name, parent, root_id, time.time_ns()))
        _open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.records[self.index].end_ns = time.time_ns()
        # a span opened before the last start() closes its own record only
        if _open and _open[-1] == self.index and self.records is _records:
            _open.pop()
        return False


def span(name: str, root_id: Optional[int] = None):
    """A context manager marking the phase ``name``; ``root_id`` names a
    root span's id (ignored under another span, whose id it shares)."""
    if not _on:
        return _NULL
    return _Span(name, root_id)


def start() -> None:
    """Clear the records and turn tracing on."""
    global _on, _records, _open, _roots
    _records, _open, _roots = [], [], 0
    _on = True


def stop() -> List[Record]:
    """Turn tracing off and return the records since ``start()``, in the
    order the spans opened (none after the first ``stop()``)."""
    global _on, _records, _open
    out, _records, _open, _on = _records, [], [], False
    return out
