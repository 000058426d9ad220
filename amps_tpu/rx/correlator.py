"""RECC burst detection: matched-filter correlator bank + block-parallel
timing recovery.

The reference finds bursts with byte-exact ``memmem`` over hard-sliced
symbols after a per-sample Mueller&Müller feedback loop
(lib/recc_impl.cc:76-79,118; clock_recovery_mm omega=10).  That loop is
inherently sequential — the one part of the reference that cannot map to an
array machine.  The array-idiomatic replacement (SURVEY.md §3.5 note):

1. correlate the oversampled FM-demod signal against the ±1 Manchester
   template of the 37-bit seizure trigger (26 dotting + 11 word-sync bits,
   lib/recc_impl.cc:76) — one conv, all offsets tested in parallel;
2. the correlation peak gives burst timing to within half an input sample
   (the dotting preamble is a timing estimation sequence by design);
3. integrate-and-dump each of the 3374 captured Manchester symbols
   (capture_len, lib/recc_impl.cc:70) at the recovered offset and slice.

Detection quality: the normalized correlation threshold plays the role of
the reference's exact-match requirement but tolerates channel noise; with
threshold 1.0-equivalent hard matching it reproduces memmem exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

TRIGGER_BITS = np.concatenate(
    [np.tile(np.array([1, 0], np.uint8), 13),
     np.array([1, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0], np.uint8)]
)  # 26 dotting + 11 word-sync bits (lib/recc_impl.cc:76)
TRIGGER_SYMBOLS = 2 * len(TRIGGER_BITS)  # 74 Manchester symbols
CAPTURE_SYMBOLS = 3374                   # DCC(7)+7x240 bits, x2 (recc_impl.cc:70)
# Per-burst DC estimate window: DCC (14 symbols) + word 1 (480 symbols).
# Every valid RECC burst carries at least DCC + one word, and Manchester
# encoding makes the window exactly DC-free, so its mean is an unbiased
# estimate of the discriminator's DC bias (carrier frequency offset: the
# AMPS mobile tolerance of +-2.5 ppm at 835 MHz is +-2.1 kHz, which the
# FM discriminator turns into a DC shift of ~26% of symbol amplitude —
# enough to break slicing at 0; the reference's binary_slicer_fb has the
# same defect, tools/cfo_sweep.py measures the cliff at 2 kHz).
DC_EST_SYMBOLS = 2 * 7 + 2 * 5 * 48      # 494


def _dc_slice(soft):
    """Hard 0/1 symbols from soft captures (..., K, CAPTURE_SYMBOLS),
    sliced against the per-burst DC estimate instead of 0."""
    dc = jnp.mean(soft[..., :DC_EST_SYMBOLS].astype(jnp.float32),
                  axis=-1, keepdims=True)
    return soft >= dc.astype(soft.dtype)


@functools.cache
def trigger_template(sps: int) -> np.ndarray:
    """±1 float32 template of the trigger at sps samples/symbol."""
    first = np.where(TRIGGER_BITS == 0, 1.0, -1.0).astype(np.float32)
    pair = np.stack([first, -first], axis=1).reshape(-1)
    return np.repeat(pair, sps)


CORR_BLOCK = 256   # output lags per Toeplitz block (not tuned on the GPU)


def _win_pieces(width: int, stride: int) -> int:
    return -(-width // stride)


def _windowed(x, stride: int, width: int, nblk: int):
    """Overlapping windows (..., nblk, width), win[i] = x[i*stride :
    i*stride+width], built from ceil(width/stride) shifted reshapes and
    ONE concat.  (A stack of nblk slices lowers to an nblk-operand
    concatenate whose cost scales with the operand count: measured
    21.9 ms for 128 slices/channel in find_bursts at M=128.)
    ``x`` must have at least (nblk + pieces - 1) * stride elements
    (zero-pad first).
    """
    k = _win_pieces(width, stride)
    pieces = [
        x[..., i * stride: (i + nblk) * stride].reshape(
            x.shape[:-1] + (nblk, stride))
        for i in range(k)
    ]
    return jnp.concatenate(pieces, axis=-1)[..., :width]


@functools.cache
def _detection_kernels(sps: int, O: int = CORR_BLOCK):
    """Banded Toeplitz matmul operator computing both correlations.

    A 222-tap C=1 conv can re-read the input once per tap (~7 GB of
    memory traffic for a 1024x8192 demod block).  Blocked as a Toeplitz
    matmul, each input window is read ONCE and all lags are one matmul:

      out[b*O + j, k] = sum_u x[b*O + j + u] tmpl_k[u]
                      = (win_b @ T)[j, k],   win_b = x[b*O : b*O+O+L-1]

    T: (O+L-1, 2*O) with T[j:j+L, j] = full template and
    T[j+ws_off:j+L, O+j] = word-sync tail (zero head keeps both outputs
    indexed at the same trigger-start offset).  E is the matching
    banded-ones operator: (win^2) @ E gives the exact sliding window
    energies the quality normalization needs.
    """
    tmpl = trigger_template(sps)
    L = len(tmpl)
    ws_off = 2 * 26 * sps
    T = np.zeros((O + L - 1, 2 * O), np.float32)
    E = np.zeros((O + L - 1, 2 * O), np.float32)
    for j in range(O):
        T[j: j + L, j] = tmpl
        T[j + ws_off: j + L, O + j] = tmpl[ws_off:]
        E[j: j + L, j] = 1.0
        E[j + ws_off: j + L, O + j] = 1.0
    tnorm = float(np.sqrt(np.sum(tmpl * tmpl)))
    wsnorm = float(np.sqrt(np.sum(tmpl[ws_off:] ** 2)))
    return T, E, L, ws_off, tnorm, wsnorm


@functools.partial(jax.jit, static_argnames=("sps", "max_bursts",
                                             "corr_block"))
def find_bursts(demod, sps: int, max_bursts: int = 4,
                threshold: float = 0.6, corr_block: int = CORR_BLOCK):
    """Locate up to ``max_bursts`` trigger hits in an FM-demod block.

    demod: (..., n) float32 (discriminator output, data is ±sensitivity).
    Returns (starts (..., K) int32 — index of the first capture sample
    (just past the trigger), valid (..., K) bool, quality (..., K) float32
    normalized correlation).  Peaks below ``threshold`` (cosine-normalized)
    are marked invalid.  Greedy non-maximum suppression masks ±1 trigger
    length around each accepted peak.
    """
    x = jnp.asarray(demod, jnp.float32)
    T, E, L, ws_off, tnorm, wsnorm = _detection_kernels(sps, corr_block)
    O = corr_block
    n = x.shape[-1]
    no = n - L + 1                                 # valid lags
    nblk = -(-no // O)
    npad = (nblk + _win_pieces(O + L - 1, O) - 1) * O
    xp = jnp.concatenate(
        [x, jnp.zeros(x.shape[:-1] + (npad - n,), x.dtype)], axis=-1) \
        if npad > n else x[..., :npad]
    wins = _windowed(xp, O, O + L - 1, nblk)       # (..., nblk, O+L-1)
    out = wins @ jnp.asarray(T)                    # (..., nblk, 2*O)
    # window energies from the SAME window stack (exact box sums — no
    # cumsum cancellation in silent stretches), one more matmul
    een = (wins * wins) @ jnp.asarray(E)

    def unblk(a):
        return a.reshape(x.shape[:-1] + (nblk * O,))[..., :no]

    corr, ws_corr = unblk(out[..., :O]), unblk(out[..., O:])
    energy = unblk(een[..., :O])
    ws_energy = unblk(een[..., O:])
    # cosine similarity of the full template AND of the word-sync tail:
    # idle dotting alone correlates ~0.7 with the full template (52 of
    # its 74 symbols are dotting) but ~0 with the tail; a real trigger
    # scores ~1 on both.
    q_full = corr / (jnp.sqrt(jnp.maximum(energy, 1e-9)) * tnorm)
    q_ws = ws_corr / (jnp.sqrt(jnp.maximum(ws_energy, 1e-9)) * wsnorm)
    quality = jnp.minimum(q_full, q_ws)

    def body(carry, _):
        q = carry
        idx = jnp.argmax(q, axis=-1)
        peak = jnp.take_along_axis(q, idx[..., None], axis=-1)[..., 0]
        # mask the full capture extent forward (+ L backward) so the
        # next iteration finds the next burst — random word data inside
        # an active capture can correlate above threshold, and the
        # reference's memmem search likewise resumes only after the
        # capture (lib/recc_impl.cc:118-126)
        pos = jnp.arange(q.shape[-1])
        mask = ((pos > idx[..., None] - L)
                & (pos < idx[..., None] + L + CAPTURE_SYMBOLS * sps))
        q = jnp.where(mask, -jnp.inf, q)
        return q, (idx, peak)

    _, (idxs, peaks) = lax.scan(body, quality, None, length=max_bursts)
    # scan stacks on axis 0 -> move to last
    idxs = jnp.moveaxis(idxs, 0, -1)
    peaks = jnp.moveaxis(peaks, 0, -1)
    starts = (idxs + L).astype(jnp.int32)
    valid = peaks >= threshold
    return starts, valid, peaks


@functools.partial(jax.jit, static_argnames=("sps", "max_bursts",
                                              "corr_block", "out_bf16"))
def find_bursts_phases(phases, sps: int, max_bursts: int = 4,
                       threshold: float = 0.6, corr_block: int = 128,
                       out_bf16: bool = False):
    """Symbol-domain burst detection on integrate-and-dump phase streams.

    phases: (..., sps, nsym) from symbol_phase_streams.  Correlating the
    74-symbol trigger template against the sps symbol-rate streams tests
    exactly the same sample-domain start offsets as find_bursts (start
    s = p + k*sps <-> phase p, symbol lag k) with sps x fewer MACs per
    template tap and sps x shorter templates (~9x less matmul work at
    sps=3), and the phase streams are shared with burst extraction —
    the integrate-and-dump is the matched filter for the rectangular
    symbol pulse, so detection quality is equal or better.

    Returns (starts, valid, quality) with starts in SAMPLE units
    (index of the first capture sample, same convention as find_bursts);
    greedy NMS masks +-1 trigger length in sample units across all
    phases jointly.
    """
    x = jnp.asarray(phases)
    if x.dtype != jnp.bfloat16:
        x = x.astype(jnp.float32)
    T, E, L, ws_off, tnorm, wsnorm = _detection_kernels(1, corr_block)
    O = corr_block
    assert O >= L - 1, (O, L)
    nsym = x.shape[-1]
    no = nsym - L + 1
    nblk = -(-no // O)
    npad = (nblk + 1) * O
    xp = jnp.concatenate(
        [x, jnp.zeros(x.shape[:-1] + (npad - nsym,), x.dtype)], axis=-1) \
        if npad > nsym else x[..., :npad]
    # window width O+L-1 <= 2O, so the Toeplitz product splits into two
    # piece matmuls on pure reshape VIEWS of xp — the (..., nblk, O+L-1)
    # window stack is never materialized (it is ~1.6x the input and was
    # read twice, for T and for E)
    Tj, Ej = np.zeros((2, O, 2 * O), np.float32), \
        np.zeros((2, O, 2 * O), np.float32)
    Tj[0], Ej[0] = T[:O], E[:O]
    Tj[1, :L - 1], Ej[1, :L - 1] = T[O:], E[O:]
    p0 = xp[..., : nblk * O].reshape(x.shape[:-1] + (nblk, O))
    p1 = xp[..., O: (nblk + 1) * O].reshape(x.shape[:-1] + (nblk, O))

    # out_bf16: write the correlation/energy matmul outputs (the biggest
    # arrays this stage touches — 2x (..., nblk, 2*O) per operator) and
    # the derived quality plane in bfloat16.  Accumulation stays f32;
    # quality only feeds a >= threshold compare and an argmax
    # ranking, which tolerate 8-bit mantissas.
    acc_t = jnp.bfloat16 if out_bf16 else jnp.float32

    # Four thin (O, 2O) matmuls.  A fused square (4O, 4O) block GEMM
    # with LHS = [p0 | p1 | p0^2 | p1^2] would materialize an extra
    # operand copy and its block zeros double the MACs; the thin form's
    # operands are pure reshape views.
    def mm(a, W):   # matmul in the data dtype, f32 accumulation
        return jnp.matmul(a, jnp.asarray(W).astype(x.dtype),
                          preferred_element_type=acc_t)

    out = mm(p0, Tj[0]) + mm(p1, Tj[1])
    een = mm(p0 * p0, Ej[0]) + mm(p1 * p1, Ej[1])

    def unblk(a):
        return a.reshape(x.shape[:-1] + (nblk * O,))[..., :no]

    corr, ws_corr = unblk(out[..., :O]), unblk(out[..., O:])
    energy, ws_energy = unblk(een[..., :O]), unblk(een[..., O:])
    q_full = corr / (jnp.sqrt(jnp.maximum(energy, acc_t(1e-9))) * acc_t(tnorm))
    q_ws = ws_corr / (jnp.sqrt(jnp.maximum(ws_energy, acc_t(1e-9)))
                      * acc_t(wsnorm))
    quality = jnp.minimum(q_full, q_ws)            # (..., sps, no)
    # flatten phases+lags; NMS in sample units (pos = p + k*sps)
    batch = x.shape[:-2]
    qf = quality.reshape(batch + (sps * no,))
    pos = (jnp.arange(sps)[:, None] + sps * jnp.arange(no)[None, :]) \
        .reshape(-1)

    # Unrolled greedy NMS (max_bursts is static and small): each
    # argmax's input is the ORIGINAL quality with the accepted
    # neighborhoods masked lazily, so XLA fuses the masking into the
    # reduce — no per-iteration carry materialization (a scan writes +
    # re-reads the full (..., sps*no) plane every step; at 1024 channels
    # that is ~2x 32 MB of pure HBM traffic per extra burst).
    spos_l, peaks_l = [], []
    q = qf
    for k in range(max_bursts):
        idx = jnp.argmax(q, axis=-1)
        peak = jnp.take_along_axis(q, idx[..., None], axis=-1)[..., 0]
        s = pos[idx]                               # (...,) sample pos
        spos_l.append(s)
        peaks_l.append(peak.astype(jnp.float32))
        if k + 1 < max_bursts:
            # suppress the FULL capture extent forward of each accepted
            # trigger, not just +-L: random word data inside an active
            # burst correlates at ~0.6 often enough to re-trigger
            # (observed at 420-burst scale in the long soak).
            # The reference cannot re-trigger there either — its memmem
            # search resumes after the 3374-symbol capture
            # (lib/recc_impl.cc:118-126).
            mask = ((pos > s[..., None] - L * sps)
                    & (pos < s[..., None]
                       + (L + CAPTURE_SYMBOLS) * sps))
            q = jnp.where(mask, acc_t(-jnp.inf), q)
    spos = jnp.stack(spos_l, axis=-1)
    peaks = jnp.stack(peaks_l, axis=-1)
    starts = (spos + L * sps).astype(jnp.int32)
    valid = peaks >= threshold
    return starts, valid, peaks


@functools.partial(jax.jit, static_argnames=("sps",))
def trigger_errors(phases, starts, sps: int):
    """Post-capture trigger verification: hard-slice the 74 trigger
    symbols PRECEDING each candidate start and count mismatches against
    the exact trigger pattern — the array equivalent of the reference's
    exact ``memmem`` symbol match (lib/recc_impl.cc:118), which can
    never fire on silence or misaligned data.

    Why it exists (the 64-block streaming soak's triage): under
    CFO + deep fading the normalized correlation occasionally clears the
    threshold a few hundred symbols BEFORE a real burst (or on noise).
    Such a false candidate becomes complete-in-window one small block
    earlier than the true burst, reports first, and the position dedup
    then swallows the true report — a word_ok=True wrong-word delivery.
    The false capture's trigger region is silence/noise (~50% symbol
    mismatches); a genuinely decodable burst slices its trigger almost
    perfectly.  Gating candidates on this count removes the false
    trigger before it can consume the dedup slot.

    phases: (..., sps, nsym); starts: (..., K) in SAMPLE units (first
    capture sample).  Returns (..., K) int32 mismatch counts over the
    in-window part of the trigger; symbols before the window start are
    not counted (callers scale the threshold by TRIGGER_SYMBOLS).

    Implementation: the same blocked one-hot selection + binary-shift
    realign as extract_from_phases (no gathers, no full-width one-hot —
    the selector is (..., K, 2, sps*nb), a few hundred lanes wide).
    """
    B = SYM_BLOCK
    nsym = phases.shape[-1]
    nb = -(-nsym // B)
    batch = phases.shape[:-2]
    ph_pad = jnp.concatenate(
        [phases, jnp.zeros(batch + (phases.shape[-2], nb * B - nsym),
                           phases.dtype)], axis=-1)
    blocks = ph_pad.reshape(batch + (phases.shape[-2] * nb, B))
    st = jnp.asarray(starts, jnp.int32)
    ph = st % sps
    t0 = st // sps - TRIGGER_SYMBOLS                 # trigger start sym
    n_cut = jnp.maximum(-t0, 0)                      # symbols before win
    b0 = ph * nb + t0 // B                           # floor div: t0 < 0 ok
    r = t0 % B                                       # Python semantics: >= 0
    nout = 2                                         # 74+127 < 2*128
    tgt = b0[..., None] + jnp.arange(nout)           # (..., K, 2)
    # keep only phase ph's own block range; before-window or next-phase
    # targets select nothing -> zero symbols (masked by `avail` below)
    in_range = (tgt >= ph[..., None] * nb) & (tgt < (ph + 1)[..., None] * nb)
    tgt = jnp.where(in_range, tgt, phases.shape[-2] * nb)
    sel = (tgt[..., None] == jnp.arange(phases.shape[-2] * nb)) \
        .astype(blocks.dtype)
    coarse = jnp.einsum("...kjb,...bl->...kjl", sel, blocks,
                        preferred_element_type=jnp.float32)
    flat = coarse.reshape(batch + (st.shape[-1], nout * B))
    for bit in range(B.bit_length() - 1):            # realign by r < B
        amt = 1 << bit
        shifted = jnp.concatenate(
            [flat[..., amt:],
             jnp.zeros(flat.shape[:-1] + (amt,), flat.dtype)], axis=-1)
        flat = jnp.where((r[..., None] & amt) > 0, shifted, flat)
    soft = flat[..., :TRIGGER_SYMBOLS]               # (..., K, 74)
    # Manchester pairs are DC-balanced per bit, so the window mean is an
    # unbiased DC (CFO) estimate over the trigger itself
    dc = jnp.mean(soft, axis=-1, keepdims=True)
    hard = soft >= dc
    patt = jnp.asarray(trigger_template(1) > 0)      # (74,) expected
    # count mismatches only over symbols actually inside the window
    avail = jnp.arange(TRIGGER_SYMBOLS) >= n_cut[..., None]
    return jnp.sum((hard != patt) & avail, axis=-1).astype(jnp.int32)


# Default gate: a real burst that decodes slices its trigger with ~0-3
# mismatches even at the BER floor; silence/misaligned windows score
# ~37/74, and the bf16-leakage FM-capture ghosts (seen only on a
# device running the bf16 transform, never on the f32 CPU path) scored
# 8-14.  6 separates all observed populations.
MAX_TRIGGER_ERRORS = 6


def apply_trigger_gate(valid, phases, starts, sps: int, max_err: int):
    """valid &= (trigger slices exactly, within max_err mismatches);
    max_err < 0 disables the gate."""
    if max_err < 0:
        return valid
    return valid & (trigger_errors(phases, starts, sps) <= max_err)


RSSI_BLOCK = 384   # power-series samples per rssi block (128 sym @ sps 3)


def window_power_blocks(parts, B: int = RSSI_BLOCK):
    """Per-block means over a VIRTUAL concatenation of per-sample power
    parts (last axis), zero-padded to whole blocks — numerically the
    reduction ``burst_rssi`` used to run on the concatenated series,
    WITHOUT materializing that concatenation.

    Why: the power series is an intermediate of the demod fusion
    ((M, Nh) f32 — ~100 MB/block at the bench config); concatenating it
    with the carried overlap and re-reading it inside burst_rssi is
    pure memory traffic.  Reducing each part in place lets XLA fuse the
    blocked sum into the producer, so only the (..., nb) block means and
    the (..., OVR) carry tail ever reach device memory.
    """
    total = sum(int(p.shape[-1]) for p in parts)
    nb = -(-total // B)
    batch = parts[0].shape[:-1]
    out = jnp.zeros(batch + (nb,), jnp.float32)
    off = 0
    for p in parts:
        n = int(p.shape[-1])
        if n == 0:
            continue
        p = jnp.asarray(p, jnp.float32)
        o = off % B
        b0 = off // B
        nbp = -(-(o + n) // B)
        pad = [(0, 0)] * (p.ndim - 1) + [(o, nbp * B - o - n)]
        sums = jnp.sum(jnp.pad(p, pad).reshape(batch + (nbp, B)), axis=-1)
        out = out.at[..., b0: b0 + nbp].add(sums)  # static offsets
        off += n
    return out / jnp.float32(B)


def power_from_blocks(blk, n: int):
    """Per-stream sqrt(mean power) reconstructed from
    window_power_blocks output over an n-sample window (the zero-pad
    dilution is undone by scaling with the true sample count)."""
    return jnp.sqrt(jnp.sum(blk, axis=-1) * jnp.float32(RSSI_BLOCK / n))


@functools.partial(jax.jit, static_argnames=("sps",))
def burst_rssi_blocks(blk, starts, sps: int):
    """Per-candidate band power over the candidate's OWN capture extent,
    from precomputed per-block power means (window_power_blocks).

    A per-block per-channel mean rssi cannot separate an adjacent-
    channel FM-capture ghost from a real burst sharing the block with
    one (the ghost rides the real burst's power); measuring over
    [start, start+capture)
    restores the 20+ dB ghost/real separation regardless of what else
    the channel carried that block.

    blk: (..., nb) block means aligned with the demod window the starts
    index into; starts: (..., K) sample units.  Returns sqrt(mean) over
    the capture extent, (..., K) f32.
    """
    B = RSSI_BLOCK
    nb = blk.shape[-1]
    st = jnp.asarray(starts, jnp.int32)
    b0 = st // B
    nsel = CAPTURE_SYMBOLS * sps // B + 1                  # 27 blocks
    tgt = b0[..., None] + jnp.arange(nsel)                 # (..., K, nsel)
    tgt = jnp.where(tgt < nb, tgt, nb)
    sel = (tgt[..., None] == jnp.arange(nb)).astype(jnp.float32)
    picked = jnp.einsum("...kjb,...b->...kj", sel, blk,
                        preferred_element_type=jnp.float32)
    return jnp.sqrt(jnp.mean(picked, axis=-1))


@functools.partial(jax.jit, static_argnames=("sps",))
def burst_rssi(pw_series, starts, sps: int):
    """Per-candidate capture-extent band power from a materialized
    per-sample power series (see burst_rssi_blocks; hot paths pass
    window_power_blocks output instead so the series never hits HBM)."""
    return burst_rssi_blocks(window_power_blocks([pw_series]), starts, sps)


SYM_BLOCK = 128    # symbols per integrate-and-dump matmul block


@functools.cache
def _dump_matrix(sps: int) -> np.ndarray:
    """(SYM_BLOCK*sps + sps - 1, sps*SYM_BLOCK) blocked integrate-and-
    dump operator: out[:, p*B + j] = mean(x[p + j*sps : p + (j+1)*sps])
    for a window of B=SYM_BLOCK symbols.  A direct reshape(nsym, sps)
    .mean(-1) puts sps(=3) on the minor axis (rows of three); as a
    windowed matmul the phase streams cost one matmul."""
    B = SYM_BLOCK
    W = np.zeros((B * sps + sps - 1, sps * B), np.float32)
    for p in range(sps):
        for j in range(B):
            W[p + j * sps: p + (j + 1) * sps, p * B + j] = 1.0 / sps
    return W


@functools.partial(jax.jit, static_argnames=("sps",))
def symbol_phase_streams(demod, sps: int):
    """(..., n) demod -> (..., sps, nsym) integrate-and-dump streams
    (phase p stream k = mean(x[p + k*sps : p + (k+1)*sps])).
    bfloat16 input stays bfloat16 (f32-accumulated matmul): the chip is
    bandwidth-bound, and the downstream consumers (trigger correlation,
    hard slicing) tolerate 8-bit mantissas (tests/test_bf16.py)."""
    x = jnp.asarray(demod)
    if x.dtype != jnp.bfloat16:
        x = x.astype(jnp.float32)
    n = x.shape[-1]
    nsym = (n - (sps - 1)) // sps
    B = SYM_BLOCK
    nblk = -(-nsym // B)
    win = B * sps + sps - 1
    npad = (nblk + _win_pieces(win, B * sps) - 1) * B * sps
    xp = jnp.concatenate(
        [x, jnp.zeros(x.shape[:-1] + (max(npad - n, 0),), x.dtype)],
        axis=-1)
    wins = _windowed(xp, B * sps, win, nblk)            # (..., nblk, win)
    W = jnp.asarray(_dump_matrix(sps)).astype(x.dtype)
    out = jnp.matmul(wins, W,
                     preferred_element_type=jnp.float32).astype(x.dtype)
    out = out.reshape(x.shape[:-1] + (nblk, sps, B))
    out = jnp.swapaxes(out, -3, -2)                     # (..., sps, nblk, B)
    return out.reshape(x.shape[:-1] + (sps, nblk * B))[..., :nsym]


@functools.partial(jax.jit, static_argnames=("sps",))
def extract_bursts_batched(demod_p, starts, sps: int):
    """Batched capture WITHOUT per-burst DMAs.

    demod_p: (..., n) demod padded so start + CAP*sps <= n for every
    valid start; starts: (..., K).  Returns (hard (..., K, 3374) uint8,
    soft float32).

    A vmapped dynamic_slice costs one ~8 µs DMA per burst on this
    hardware (2048 bursts = 16 ms).  Instead the capture is a dense
    one-hot matmul over 128-symbol blocks of the phase streams (the
    selector comes from an iota comparison — no gather anywhere),
    followed by a 7-step binary-shift realign for the within-block
    offset.  Invalid starts beyond the padded range yield zeros (the
    decoder then reports word_ok=False), where dynamic_slice would
    have clamped; callers mask by ``valid`` either way.
    """
    phases = symbol_phase_streams(demod_p, sps)     # (..., sps, nsym)
    return extract_from_phases(phases, starts, sps)


@functools.partial(jax.jit, static_argnames=("sps", "hard_dtype", "lead"))
def extract_from_phases(phases, starts, sps: int, hard_dtype=jnp.uint8,
                        lead: int = 0):
    """Burst capture from precomputed phase streams (..., sps, nsym)
    (see extract_bursts_batched; sharing the streams with
    find_bursts_phases avoids recomputing the integrate-and-dump).
    hard_dtype: dtype of the hard 0/1 symbols — pass jnp.bfloat16 when
    the consumer is the symbol-domain decoder (rx/decoder.py), which
    eats bf16 directly and skips a uint8 round-trip.

    ``lead``: additionally extract this many symbols PRECEDING each
    start in the same one-hot pass and return them as a third output
    (..., K, lead) — used with lead=TRIGGER_SYMBOLS so post-capture
    trigger verification rides the capture's existing full-plane read
    instead of re-reading phases.
    The assert bounds lead so the capture tail can never be shifted
    past the extracted buffer: the realign offset r reaches B-1, so
    lead + CAPTURE_SYMBOLS + (B-1) must fit in nout*B (r3 advisor
    finding — the old 2*B - CAPTURE%%B bound silently zero-truncated
    tail symbols for lead in (83, 210]).  Lead symbols before the
    window start select nothing and come back as zeros (floor-division
    targeting, same as trigger_errors); trigger_errors_soft masks them
    out of its mismatch count."""
    B = SYM_BLOCK
    nout = -(-CAPTURE_SYMBOLS // B) + 1             # blocks incl realign
    assert 0 <= lead <= nout * B - CAPTURE_SYMBOLS - (B - 1), lead
    nsym = phases.shape[-1]
    nb = -(-nsym // B)
    batch = phases.shape[:-2]
    ph_pad = jnp.concatenate(
        [phases, jnp.zeros(batch + (sps, nb * B - nsym,), phases.dtype)],
        axis=-1)
    blocks = ph_pad.reshape(batch + (sps * nb, B))
    st = jnp.asarray(starts, jnp.int32)
    ph = st % sps
    k0 = st // sps - lead                           # may be < 0: floor
    b0 = ph * nb + k0 // B                          # (..., K)
    r = k0 % B                                      # Python mod: >= 0
    tgt = b0[..., None] + jnp.arange(nout)          # (..., K, nout)
    # keep only phase p's own block range: a window crossing the stream
    # tail must read zeros, not the NEXT phase's blocks, and lead
    # symbols before the stream head must read zeros, not the PREVIOUS
    # phase's blocks (this is what a zero pad used to mask — the range
    # mask makes the pad unnecessary)
    in_range = ((tgt >= ph[..., None] * nb)
                & (tgt < (ph + 1)[..., None] * nb))
    tgt = jnp.where(in_range, tgt, sps * nb)
    sel = (tgt[..., None] == jnp.arange(sps * nb)).astype(blocks.dtype)
    coarse = jnp.einsum("...kjb,...bl->...kjl", sel, blocks,
                        preferred_element_type=jnp.float32) \
        .astype(blocks.dtype)
    flat = coarse.reshape(batch + (st.shape[-1], nout * B))
    for bit in range(B.bit_length() - 1):           # realign by r < B
        amt = 1 << bit
        shifted = jnp.concatenate(
            [flat[..., amt:],
             jnp.zeros(flat.shape[:-1] + (amt,), flat.dtype)], axis=-1)
        flat = jnp.where((r[..., None] & amt) > 0, shifted, flat)
    soft = flat[..., lead: lead + CAPTURE_SYMBOLS]
    if lead == 0:
        return _dc_slice(soft).astype(hard_dtype), soft
    return _dc_slice(soft).astype(hard_dtype), soft, flat[..., :lead]


def trigger_errors_soft(trig_soft, starts=None, sps: int = 1):
    """Trigger mismatch counts from extracted lead symbols
    (..., K, TRIGGER_SYMBOLS) — the extraction-fused form of
    trigger_errors (same DC-estimate hardening, same pattern).

    ``starts`` (optional, SAMPLE units): mask symbols that precede the
    stream head — extract_from_phases returns zeros there, which would
    otherwise score against the template (~37 mismatches) where the
    standalone trigger_errors counts only in-window symbols (r3 advisor
    finding).  find_bursts_phases starts are always
    >= TRIGGER_SYMBOLS*sps, so omitting starts is equivalent for them."""
    soft = trig_soft.astype(jnp.float32)
    dc = jnp.mean(soft, axis=-1, keepdims=True)
    hard = soft >= dc
    patt = jnp.asarray(trigger_template(1) > 0)      # (74,) expected
    bad = hard != patt
    if starts is not None:
        st = jnp.asarray(starts, jnp.int32)
        n_cut = jnp.maximum(TRIGGER_SYMBOLS - st // sps, 0)
        bad = bad & (jnp.arange(TRIGGER_SYMBOLS) >= n_cut[..., None])
    return jnp.sum(bad, axis=-1).astype(jnp.int32)


def apply_trigger_gate_soft(valid, trig_soft, max_err: int,
                            starts=None, sps: int = 1):
    """valid &= trigger slices exactly, from extraction-fused lead
    symbols; max_err < 0 disables."""
    if max_err < 0:
        return valid
    return valid & (trigger_errors_soft(trig_soft, starts, sps) <= max_err)


@functools.partial(jax.jit, static_argnames=("sps",))
def extract_burst_symbols(demod, starts, sps: int):
    """Integrate-and-dump capture: for each start index, take
    CAPTURE_SYMBOLS Manchester symbols at sps samples each.

    demod: (n,) float32; starts: (K,) int32 (first capture sample).
    Returns (hard (K, 3374) uint8, soft (K, 3374) float32).
    Callers must ensure demod is padded so start+3374*sps <= n
    (dynamic_slice clamps; the streaming wrapper guarantees overlap).

    Implementation: integrate-and-dump once per sample phase (sps
    symbol-rate streams, via the blocked matmul above), then slice
    CAPTURE_SYMBOLS from the stream matching each burst's phase —
    per-burst work drops from 3374*sps samples to 3374.
    """
    phases = symbol_phase_streams(demod, sps)       # (sps, nsym)

    def one(start):
        start = start.astype(jnp.int32)
        ph = start % sps
        k0 = start // sps
        seg = lax.dynamic_slice(phases, (ph, k0), (1, CAPTURE_SYMBOLS))
        return seg[0]

    soft = jax.vmap(one)(starts)
    hard = _dc_slice(soft).astype(jnp.uint8)
    return hard, soft


@functools.partial(jax.jit, static_argnames=("sps", "max_bursts"))
def find_and_extract(demod, sps: int, max_bursts: int = 4,
                     threshold: float = 0.6):
    """Fused detection + capture for one (possibly batched) demod block."""
    starts, valid, quality = find_bursts(demod, sps, max_bursts, threshold)
    if demod.ndim == 1:
        hard, soft = extract_burst_symbols(demod, starts, sps)
    else:
        hard, soft = jax.vmap(
            lambda d, s: extract_burst_symbols(d, s, sps)
        )(demod, starts)
    return starts, valid, quality, hard, soft
