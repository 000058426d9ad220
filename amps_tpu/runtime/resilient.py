"""Failure detection + elastic recovery for the streaming receiver.

The reference has neither (SURVEY.md §5: a GR thread that dies takes
the flowgraph down).  Here the receiver's carried state is explicit
(runtime/state.py), so recovery is cheap and exact:

* every ``checkpoint_blocks`` pushes, snapshot the carried state on the
  host and drop the replay ring;
* if the receiver's push raises (device lost/preempted/hung, XLA
  runtime error), build a FRESH receiver via the factory (new device
  buffers and executables), restore the snapshot, replay the retained
  blocks, and continue — the resumed stream is bit-identical to an
  uninterrupted one (same guarantee tests/test_state.py pins for
  checkpoint/resume);
* burst callbacks are delivered exactly once across replays (reports
  are deduplicated by (channel, absolute symbol index)); callback
  exceptions propagate to the caller and never trigger a rebuild.

The caller keeps feeding blocks; only a receiver error that persists
through ``max_retries`` rebuilds is re-raised.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import numpy as np

from amps_tpu.runtime.state import restore_receiver, snapshot_receiver
from amps_tpu.runtime.streamer import BurstReport


class ResilientReceiver:
    """Elastic wrapper: ``make_receiver`` is a zero-argument factory
    returning a fresh MultichannelReceiver configured WITHOUT an
    on_burst callback — reports flow through this wrapper's return
    values / ``on_burst`` so replay deduplication can apply."""

    def __init__(self, make_receiver: Callable[[], object],
                 checkpoint_blocks: int = 4, max_retries: int = 2,
                 on_burst: Optional[Callable[[BurstReport], None]] = None):
        self._make = make_receiver
        self.rx = make_receiver()
        # the snapshot is the state AFTER every pushed block has fully
        # drained; a depth>1 receiver keeps undrained device entries in
        # flight, which a snapshot cannot represent
        assert getattr(self.rx, "depth", 1) == 1, \
            "ResilientReceiver requires pipeline_depth=1"
        # a callback on the inner receiver would bypass replay dedup
        # (duplicate call-control actions after a recovery)
        assert getattr(self.rx, "on_burst", None) is None, \
            "configure on_burst on ResilientReceiver, not the factory"
        self.checkpoint_blocks = max(1, checkpoint_blocks)
        self.max_retries = max_retries
        self.on_burst = on_burst
        self._snap = snapshot_receiver(self.rx)
        self._ring: List[np.ndarray] = []
        self._delivered = set()          # (channel, abs_symbol)
        self.recoveries = 0

    # -- delivery (outside the retry loop: a callback exception must
    # -- surface to the caller, not masquerade as a device failure) ---------

    def _deliver(self, reports) -> List[BurstReport]:
        out = []
        for r in reports:
            key = (r.channel, r.abs_symbol)
            if key in self._delivered:
                continue
            self._delivered.add(key)
            out.append(r)
            if self.on_burst:
                self.on_burst(r)
        return out

    @contextlib.contextmanager
    def _sup_guard(self, cb_errors: List[BaseException]):
        """Wrap the inner receiver's on_supervision so a USER-callback
        exception is recorded and re-raised AFTER the retry loop instead
        of propagating out of rx.push, where it would masquerade as a
        device failure and trigger a rebuild+replay that re-delivers the
        block's supervision frames (double-advancing SAT/ST timers).
        The guard wraps whatever receiver is current at entry; recovery
        builds a fresh receiver inside its own guard."""
        rx = self.rx
        cb = getattr(rx, "on_supervision", None)
        if cb is None:
            yield
            return

        def guarded(*a, **kw):
            try:
                cb(*a, **kw)
            except Exception as e:  # noqa: BLE001 — user callback
                cb_errors.append(e)

        rx.on_supervision = guarded
        try:
            yield
        finally:
            # restore on the receiver that ran under the guard (self.rx
            # may already be a rebuilt instance if a device error hit)
            if getattr(rx, "on_supervision", None) is guarded:
                rx.on_supervision = cb

    # -- recovery ------------------------------------------------------------

    def _recover_and_replay_raw(
            self, cb_errors: List[BaseException]) -> List[BurstReport]:
        """Fresh receiver + snapshot restore + ring replay (raw reports;
        dedup happens at delivery).

        Supervision callbacks are suppressed for every replayed block
        except the last (the block whose original push failed): earlier
        blocks' supervision frames were already delivered before the
        failure, and re-delivering them would advance SAT/ST timers
        twice — burst reports have positional dedup, supervision frames
        do not.  The last block's delivery runs under the same
        exception guard as a normal push (``cb_errors``)."""
        self.recoveries += 1
        self.rx = self._make()
        restore_receiver(self._snap, self.rx)
        raw: List[BurstReport] = []
        saved_cb = getattr(self.rx, "on_supervision", None)
        try:
            with self._sup_guard(cb_errors):
                guarded_cb = getattr(self.rx, "on_supervision", None)
                for i, blk in enumerate(self._ring):
                    if saved_cb is not None:
                        self.rx.on_supervision = (guarded_cb
                                                  if i == len(self._ring) - 1
                                                  else None)
                    raw += self.rx.push(blk)
        finally:
            # a failed replay must not leave the rebuilt receiver with
            # its supervision callback suppressed (the caller may catch
            # and keep pushing)
            if saved_cb is not None:
                self.rx.on_supervision = saved_cb
        return raw

    # -- public API ------------------------------------------------------------

    def push(self, block) -> List[BurstReport]:
        block = np.asarray(block)
        self._ring.append(block)
        cb_errors: List[BaseException] = []
        for attempt in range(self.max_retries + 1):
            cb_errors.clear()   # a retried attempt re-delivers the frames
            try:
                if attempt == 0:
                    with self._sup_guard(cb_errors):
                        raw = self.rx.push(block)
                else:
                    raw = self._recover_and_replay_raw(cb_errors)
            except Exception:
                if attempt == self.max_retries:
                    # the block never succeeded: drop it from the ring so
                    # a caller that catches and re-pushes the same block
                    # doesn't double-append it (a later recovery would
                    # then replay it twice, breaking exactly-once)
                    self._ring.pop()
                    raise
                continue
            break
        out = self._deliver(raw)
        if len(self._ring) >= self.checkpoint_blocks:
            self._snap = snapshot_receiver(self.rx)
            self._ring.clear()
            # replay can only start at this snapshot now, so dedup keys
            # older than it can never recur — prune (the set would
            # otherwise grow one entry per burst forever)
            floor = int(self._snap["abs_base"]) // self.rx.sps \
                - (len(self._snap["carry"][0]) // self.rx.sps)
            self._delivered = {k for k in self._delivered if k[1] >= floor}
        if cb_errors:
            # user-callback failure: the push itself succeeded (state
            # advanced, reports delivered) — surface the error without
            # having triggered a rebuild (module invariant).  The
            # block's burst reports are ATTACHED to the exception
            # (``burst_reports``): they are marked in _delivered, so a
            # return-value consumer that only catches the error would
            # otherwise lose them unrecoverably (positional dedup
            # suppresses any re-push); on_burst consumers already
            # received them during delivery.
            err = cb_errors[0]
            try:
                err.burst_reports = out
            except AttributeError:
                pass    # __slots__ exception class: raise it unadorned
            raise err
        return out

    def flush(self) -> List[BurstReport]:
        """End-of-stream drain WITH the resilience contract: the
        carried-overlap burst is completed against trailing silence
        (pad_tail — the reference's ring-buffer retention at shutdown),
        and a device failure during the flush triggers the same
        rebuild+replay as a failed push (r5 review finding: flush used
        to bypass both)."""
        if self._ring and self.rx._last_block_len:
            # route the pad block through push(): it carries the full
            # retry/recovery machinery and positional dedup
            out = self.push(np.zeros((self.rx._last_block_len, 2),
                                     np.float32))
        else:
            out = []
        return out + self._deliver(self.rx.flush())
