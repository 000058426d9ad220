"""Voice-channel supervision: SAT transponder check + signaling tone.

The reference has NO supervision — the RVC variant only re-broadcasts
audio (SURVEY.md §2 'RVC monitor variant'); SAT is generated on TX
(grc/ampsbs.grc:360) but never verified on RX, so a faded mobile keeps
its channel forever.  This module adds the TIA/EIA-553 land-station
side that gr-amps left out (a conscious extension, docs/PARITY.md):

* the mobile transponds the SAT it hears back on the RVC; the land
  station confirms the returned SAT matches its own SCC and releases
  the call after a fade timeout if it does not (553 §3.8 / §2.4.2 —
  nominal 5 s);
* the 10 kHz signaling tone (ST, 553 §2.7.1.2) signals call progress:
  ST on while alerting (ringing), answer = ST drops, flash request =
  400 ms ST burst, mobile release = 1.8 s ST;
* carrier loss (RVC band power below threshold) counts as SAT loss —
  this also covers mobiles going quiet (DTX-style discontinuities are
  tolerated up to the same fade timeout).

Device side: rx.voice.supervision_levels measures [SAT0-2, ST]
amplitudes per 10 ms frame as one batched matmul; this module is the
pure-host consumer (the control plane runs on the host by design,
SURVEY.md §1 control/data split).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SupervisionConfig:
    frame_s: float = 0.01          # measurement frame (10 ms)
    sat_on_ratio: float = 0.5      # SAT present if level > ratio * nominal
    st_on_ratio: float = 0.5       # ST present if level > ratio * nominal
    sat_nominal: float = 0.05      # TX SAT amplitude (grc/ampsbs.grc:360)
    st_nominal: float = 0.05       # mobile ST deviation, normalized alike
    sat_margin_db: float = 6.0     # right SCC must beat others by this
    fade_timeout_s: float = 5.0    # SAT/carrier loss -> release (553 §2.4.2)
    st_release_s: float = 1.8      # ST >= 1.8 s -> mobile release
    st_flash_min_s: float = 0.25   # 400 ms flash window (553 §2.7.2)
    st_flash_max_s: float = 0.8
    # Answer debouncing, both directions, thresholds from the fading
    # study (tools/sup_fading_sweep.py, docs/BER.md):
    # * arm: 0.2 s of ACCUMULATED ringing ST must be heard before an ST
    #   drop can count as the answer — fading's isolated false-ST
    #   frames (runs <= 0.03 s) cannot arm it, while genuinely ringing
    #   faded signals (ST in >= 59% of carrier frames even at 6 dB
    #   fast fading) arm within ~0.4 s.  Accumulation resets only when
    #   ST is CONFIRMED off (below), so fading's short detection gaps
    #   (miss runs <= 0.05 s on a ringing signal) cannot starve it.
    # * drop: the answer fires only after st_drop_confirm_s of
    #   CONSECUTIVE quiet-with-carrier frames — a single fade-edge
    #   frame whose ST bin dips cannot fake an early answer (the ring
    #   would then accumulate in CONVERSATION to a phantom ST release).
    st_answer_arm_s: float = 0.2
    st_drop_confirm_s: float = 0.1
    # * decay: while the tone is absent but the carrier is up (quiet
    #   frames that have NOT yet confirmed an off), the ring
    #   accumulator decays at this fraction of real time instead of
    #   holding.  A PERIODIC pattern of spurious one-frame ST hits with
    #   inter-arrival < st_drop_confirm_s could otherwise ratchet the
    #   accumulator to the arm threshold without ever ringing (r4
    #   advisor finding); with half-rate decay, arming needs an ST duty
    #   cycle > 1/3 — fading's isolated false-ST hits are far sparser
    #   (runs <= 0.03 s, isolated; tools/sup_fading_sweep.py), while a
    #   genuinely ringing faded signal (ST in >= 59% of carrier frames
    #   even at 6 dB fast fading) still arms in <= ~0.6 s.
    st_arm_decay_ratio: float = 0.5
    alert_timeout_s: float = 65.0  # unanswered alert -> release
    min_power: float = 1e-6        # RVC carrier-present gate (lower)
    # Discriminator-noise squelch (upper bound): a DEAD carrier
    # demodulates to full-scale white phase noise — deviation-normalized
    # discriminator power ~pi^2/3/sens^2 ~ 4.7 — while a live FM
    # carrier's demod power is bounded by its modulation (voice+tones
    # <~0.5; full-deviation wideband data, e.g. RVC blank-and-burst,
    # sits at ~1.0).  2.0 leaves headroom above the worst legitimate
    # modulation (the r3 advisor flagged 1.0 as classifying legitimate
    # +-1-deviation data frames as carrier loss) while staying >2x
    # below the dead-carrier noise power.  Without this squelch, random
    # ST-bin hits on a dead carrier fire spurious flash events
    # (observed in the voice soak on the device: 'flash' on slot B
    # during the post-fade dead carrier).
    max_power: float = 2.0
    # ST dominance gate: the 10 kHz bin must beat the empty guard bins
    # (rx/voice.GUARD_TONES_HZ noise reference, levels column 4) by this
    # ratio, PER FRAME.  A real ST dominates by orders of magnitude;
    # dead-carrier discriminator noise is white, so its ST bin matches
    # the guard bins (ratio ~1, Rayleigh-fluctuating) — a >=2x
    # dominance run of flash length is then vanishingly unlikely even
    # for frames that slip the power squelch.  Kills the FM-click
    # spurious flash class the voice soak observed on the device.  Frames without a guard column (legacy (F, 4)
    # feeds, e.g. SimMobile.supervision_frames) skip the gate.
    st_guard_ratio: float = 2.0
    # Guard-bin carrier gate: the power squelch alone cannot catch a
    # dead carrier seen THROUGH THE CHANNELIZER — the slot filter
    # bandlimits the discriminator noise to power ~1.5-2.0, inside the
    # legitimate-modulation window (measured: mean 1.73 on a 64-channel
    # bank slot vs ~4.7 raw).  The guard bins separate the regimes
    # physically: a live FM carrier's demod noise floor is tiny (guard
    # ~0.005 with tones+voice), a dead carrier's white(ish)
    # discriminator noise puts ~0.1 in them.  Frames with guard above
    # this are treated as carrier loss (supervision freezes — also the
    # protocol-correct behavior for RVC wideband data frames, whose
    # broadband energy lands in the guard bins and which suppress
    # SAT/ST anyway, 553 §3.6).  Legacy (F, 4) feeds skip the gate.
    carrier_guard_max: float = 0.04


def classify_frames(levels, power, scc: int, cfg: "SupervisionConfig"):
    """Vectorized evaluation of the production supervision gates:
    (carrier, sat_ok, st_on) boolean arrays for (F, n_tones) levels +
    (F,) power.  THE single source of gate truth — push_frames consumes
    it per batch, and measurement tools (tools/sup_fading_sweep.py)
    must use it so their published numbers always describe the shipping
    gates.  Legacy (F, 4) feeds without the guard column skip the
    guard-based gates."""
    levels = np.asarray(levels)
    power = np.asarray(power)
    has_guard = levels.shape[-1] > 4
    margin = 10.0 ** (cfg.sat_margin_db / 20.0)
    carrier = (power > cfg.min_power) & (power < cfg.max_power)
    if has_guard:
        # channelized dead carrier slips the power window; its demod
        # noise floor in the guard bins does not
        carrier = carrier & (levels[..., 4] < cfg.carrier_guard_max)
    sat = levels[..., :3]
    mine = sat[..., scc]
    others = np.max(np.delete(sat, scc, axis=-1), axis=-1)
    sat_ok = (carrier & (mine > cfg.sat_on_ratio * cfg.sat_nominal)
              & (mine > others * margin))
    st = levels[..., 3]
    st_on = carrier & (st > cfg.st_on_ratio * cfg.st_nominal)
    if has_guard:
        # per-frame dominance over the empty guard bins: white
        # discriminator noise cannot sustain this for a flash-length
        # run, a real tone always does
        st_on = st_on & (st > cfg.st_guard_ratio * levels[..., 4])
    return carrier, sat_ok, st_on


# call states
IDLE = "idle"
ALERTING = "alerting"            # FVC alert sent, waiting for answer
CONVERSATION = "conversation"
RELEASED = "released"


@dataclasses.dataclass
class SupervisionEvent:
    kind: str       # answer|flash|release|sat_lost|sat_back
    channel: int
    reason: str = ""
    t: float = 0.0  # seconds since supervision started


class ChannelSupervisor:
    """Per-voice-channel supervision state machine.

    Feed it measurement frames (from rx.voice.supervision_levels) via
    ``push_frames``; it emits SupervisionEvents through the callback.
    """

    def __init__(self, channel: int, scc: int,
                 config: Optional[SupervisionConfig] = None,
                 on_event: Optional[Callable[[SupervisionEvent], None]] = None,
                 state: str = CONVERSATION):
        self.channel = channel
        self.scc = scc
        self.cfg = config or SupervisionConfig()
        self.on_event = on_event
        self.state = state
        self.t = 0.0
        self._sat_loss_t = 0.0     # continuous seconds without good SAT
        self._st_run_t = 0.0       # ST-present seconds (continuous in
                                   # CONVERSATION; accumulated while
                                   # ALERTING, see _step)
        self._st_quiet_t = 0.0     # consecutive quiet-with-carrier s
        self._conv_run_snap = 0.0  # run length at the ST falling edge
                                   # (flash classification under the
                                   # conversation drop-debounce)
        self._alert_t = 0.0
        self._st_seen_in_alert = False
        self.events: List[SupervisionEvent] = []

    # -- plumbing ----------------------------------------------------------

    def _emit(self, kind: str, reason: str = "") -> None:
        ev = SupervisionEvent(kind, self.channel, reason, self.t)
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    def _release(self, reason: str) -> None:
        if self.state != RELEASED:
            self.state = RELEASED
            self._emit("release", reason)

    # -- state transitions --------------------------------------------------

    def begin_alert(self) -> None:
        """FVC alert order sent; mobile should ring (ST on) until answer."""
        self.state = ALERTING
        self._alert_t = 0.0
        self._st_run_t = 0.0
        self._st_quiet_t = 0.0
        self._st_seen_in_alert = False

    def begin_conversation(self) -> None:
        self.state = CONVERSATION
        self._st_run_t = 0.0
        self._st_quiet_t = 0.0
        self._conv_run_snap = 0.0

    def push_frames(self, levels, power) -> None:
        """levels: (F, 5) amplitudes [SAT0, SAT1, SAT2, ST, GUARD] from
        rx.voice.supervision_levels (legacy (F, 4) feeds without the
        guard noise-reference column are accepted; the ST dominance
        gate is then skipped); power: (F,) demod band power — both for
        THIS channel (one row of the batched device measurement)."""
        cfg = self.cfg
        levels = np.asarray(levels)
        power = np.asarray(power)
        carrier_v, sat_ok_v, st_on_v = classify_frames(
            levels, power, self.scc, cfg)
        for f in range(levels.shape[0]):
            if self.state in (IDLE, RELEASED):
                self.t += cfg.frame_s
                continue
            self._step(bool(sat_ok_v[f]), bool(st_on_v[f]),
                       bool(carrier_v[f]))
            self.t += cfg.frame_s

    def _step(self, sat_ok: bool, st_on: bool, carrier: bool = True) -> None:
        cfg = self.cfg
        # SAT / carrier fade timing (553 §2.4.2)
        was_lost = self._sat_loss_t > 0.0
        if sat_ok or (st_on and self.state == ALERTING):
            # during alerting the mobile sends ST; treat it as proof of
            # life even if SAT measurement is degraded by the tone
            if was_lost and self._sat_loss_t >= cfg.frame_s * 3:
                self._emit("sat_back")
            self._sat_loss_t = 0.0
        else:
            self._sat_loss_t += cfg.frame_s
            if abs(self._sat_loss_t - cfg.frame_s * 3) < cfg.frame_s / 2:
                self._emit("sat_lost")
            if self._sat_loss_t >= cfg.fade_timeout_s:
                self._release("SAT fade timeout")
                return

        if self.state == ALERTING:
            self._alert_t += cfg.frame_s
            if st_on:
                # accumulate ring time; fading's short detection gaps
                # (miss runs <= 0.05 s on a ringing signal, measured)
                # do not reset it — only a CONFIRMED off does
                self._st_run_t += cfg.frame_s
                self._st_quiet_t = 0.0
                # half-frame slack: N frame_s accumulations of 0.01
                # undershoot N/100 by float epsilon
                if self._st_run_t >= cfg.st_answer_arm_s - cfg.frame_s / 2:
                    self._st_seen_in_alert = True
            elif carrier:
                # quiet-with-carrier: confirm the drop over
                # st_drop_confirm_s consecutive frames before acting —
                # a single fade-edge frame whose ST bin dips must
                # neither fire an early answer nor reset the ring
                # accumulator (553 §2.7.2 answer = sustained removal).
                # Unconfirmed quiet DECAYS the accumulator (it does not
                # hold): a periodic train of isolated spurious ST hits
                # spaced just under the confirm window can then never
                # ratchet to the arm threshold (needs duty > 1/3),
                # while real ringing through fading gaps still arms.
                self._st_run_t = max(
                    0.0, self._st_run_t - cfg.st_arm_decay_ratio * cfg.frame_s)
                self._st_quiet_t += cfg.frame_s
                if self._st_quiet_t >= cfg.st_drop_confirm_s - cfg.frame_s / 2:
                    if self._st_seen_in_alert:
                        self.begin_conversation()
                        self._emit("answer")
                        return
                    self._st_run_t = 0.0   # confirmed off: restart arm
            else:
                # carrier loss: tone state is unobservable — freeze
                # both the ring accumulator and the drop confirmation
                self._st_quiet_t = 0.0
            if self._alert_t >= cfg.alert_timeout_s:
                self._release("alert timeout (no answer)")
        elif self.state == CONVERSATION:
            if not carrier:
                # carrier died mid-run: the tone's falling edge is
                # unobservable, so the run cannot be verified as a
                # deliberate flash — discard it silently (emitting at
                # fade-start reads a fade as a flash; emitting at
                # carrier-resume delivers a stale flash seconds late)
                self._st_run_t = 0.0
                self._st_quiet_t = 0.0
                self._conv_run_snap = 0.0
            elif st_on:
                self._st_run_t += cfg.frame_s
                self._st_quiet_t = 0.0
                self._conv_run_snap = 0.0
                if self._st_run_t >= cfg.st_release_s:
                    self._release("mobile release (ST)")
            else:
                # drop-debounce (the mirror of ALERTING's confirmed-off
                # discipline): a single missed ST frame under fading
                # must not fragment a 1.8 s release run into
                # flash-length pieces — the measured fading duty (ST in
                # >= 59% of carrier frames at 6 dB fast fading, see
                # st_answer_arm_s) would otherwise break EVERY release
                # into spurious 'flash' events and leave the release to
                # the 5 s SAT fade timeout.  The run only ENDS after
                # st_drop_confirm_s of contiguous quiet; until then it
                # decays at the arm ratio (fading gaps are discounted,
                # a genuinely ended tone drains).  Flash classification
                # uses the run length AT the falling edge, not the
                # decayed value.
                if self._st_quiet_t == 0.0:
                    self._conv_run_snap = self._st_run_t
                self._st_run_t = max(
                    0.0, self._st_run_t - cfg.st_arm_decay_ratio * cfg.frame_s)
                self._st_quiet_t += cfg.frame_s
                if self._st_quiet_t >= cfg.st_drop_confirm_s - cfg.frame_s / 2:
                    if cfg.st_flash_min_s <= self._conv_run_snap \
                            <= cfg.st_flash_max_s:
                        self._emit("flash")
                    self._st_run_t = 0.0
                    self._st_quiet_t = 0.0
                    self._conv_run_snap = 0.0
