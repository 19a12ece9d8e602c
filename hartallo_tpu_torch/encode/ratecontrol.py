"""JVT-G012 quadratic rate control (frame-level / basic-unit = picture).

Reference parity: ``hl_codec_264_rc.c`` (JM-derived: quadratic model
R = (X1/Qstep + X2/Qstep^2) * MAD with linear MAD prediction, GOP bit
allocation, buffer-based target, +-DDquant QP clamp).  Re-implemented from
the G012 algorithm; state is a small pytree-friendly dataclass (the
save/restore copies the reference keeps for RD picture decision,
``hl_codec_264_rc.c:470-530``, become plain dataclasses.replace here).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List


def qp2qstep(qp: int) -> float:
    return 0.625 * (2.0 ** (qp / 6.0))


def qstep2qp(qstep: float) -> int:
    if qstep < qp2qstep(0):
        return 0
    if qstep > qp2qstep(51):
        return 51
    q = 6.0 * math.log2(qstep / 0.625)
    return int(min(51, max(0, round(q))))


@dataclass
class RateControl:
    bitrate: float                  # bits per second
    fps: float
    width: int
    height: int
    gop_size: int
    qp_min: int = 2
    qp_max: int = 51
    ddquant: int = 2                # max QP change between P frames

    # model state
    x1: float = 0.0
    x2: float = 0.0
    mad_a1: float = 1.0
    mad_a2: float = 0.0
    prev_mad: float = 1.0
    qp_prev_p: int = 0
    qp_last_i: int = 0
    buffer_level: float = 0.0
    target_level: float = 0.0
    bits_min: float = -1.0          # per-second clamps (rc_bitrate_min/max)
    bits_max: float = -1.0
    cpb_size: float = 0.0           # CPB capacity in bits (0 = 1s of rate)
    remaining_bits: float = 0.0
    np_left: int = 0
    gop_idx: int = -1
    frame_in_gop: int = 0
    sum_p_qp: int = 0
    num_p: int = 0
    # regression windows
    _rq_win: List = field(default_factory=list)     # (mad, bits_texture, qstep)
    _mad_win: List = field(default_factory=list)    # (prev_mad, mad)

    def __post_init__(self):
        bpp = self.bitrate / (self.fps * self.width * self.height)
        # G012 initial QP from bits-per-pixel (QCIF thresholds scaled)
        l1, l2, l3 = 0.15, 0.45, 0.9
        if bpp <= l1:
            qp = 35
        elif bpp <= l2:
            qp = 25
        elif bpp <= l3:
            qp = 20
        else:
            qp = 10
        self.qp_prev_p = self.qp_last_i = qp
        self.x1 = self.bitrate
        self.x2 = 0.0
        self.buffer_level = 0.0

    # ------------------------------------------------------------------
    def start_gop(self) -> None:
        self.gop_idx += 1
        bits_per_frame = self.bitrate / self.fps
        self.remaining_bits += bits_per_frame * self.gop_size
        self.np_left = self.gop_size - 1
        self.frame_in_gop = 0
        if self.gop_idx > 0 and self.num_p > 0:
            avg_p = self.sum_p_qp / max(1, self.num_p)
            self.qp_last_i = int(max(self.qp_min, min(
                self.qp_max, round(avg_p) - 2)))
        self.sum_p_qp = 0
        self.num_p = 0

    # ------------------------------------------------------------------
    def frame_qp(self, is_idr: bool) -> int:
        if is_idr:
            qp = self.qp_last_i
            self._last_was_i = True
            return int(max(self.qp_min, min(self.qp_max, qp)))
        # P frame: target bits
        bits_per_frame = self.bitrate / self.fps
        # buffer-based target (gamma blend, G012 eq. 10-12)
        gamma = 0.5
        t_buf = bits_per_frame - gamma * self.buffer_level
        # remaining-bits-based target
        t_rem = self.remaining_bits / max(1, self.np_left)
        beta = 0.5
        target = beta * t_rem + (1 - beta) * t_buf
        target = max(target, 0.1 * bits_per_frame)
        # hl_codec-style hard bitrate window: clamp the per-frame target
        if self.bits_min > 0:
            target = max(target, self.bits_min / self.fps)
        if self.bits_max > 0:
            target = min(target, self.bits_max / self.fps)

        # predicted MAD
        mad = self.mad_a1 * self.prev_mad + self.mad_a2
        mad = max(mad, 1e-3)
        # solve (X1/Q + X2/Q^2) * MAD = target  for Qstep
        t = max(target, 1.0)
        if self.x2 == 0.0:
            qstep = self.x1 * mad / t
        else:
            a, b, cc = t, -self.x1 * mad, -self.x2 * mad
            disc = b * b - 4 * a * cc
            qstep = (-b + math.sqrt(max(disc, 0.0))) / (2 * a)
            if qstep <= 0:
                qstep = self.x1 * mad / t
        qp = qstep2qp(qstep)
        qp = max(self.qp_prev_p - self.ddquant,
                 min(self.qp_prev_p + self.ddquant, qp))
        # HRD/CPB-style clamp (the reference's hrd.c is an empty shell;
        # this enforces the A.3 buffer intent): buffer_level tracks
        # occupancy above the steady-state drain — near overflow force a
        # coarser QP, near underflow allow a finer one
        cpb = self.cpb_size if self.cpb_size > 0 else self.bitrate
        if self.buffer_level > 0.45 * cpb:
            qp = max(qp, self.qp_prev_p + 1)
        elif self.buffer_level < -0.45 * cpb:
            qp = min(qp, self.qp_prev_p - 1)
        qp = max(self.qp_min, min(self.qp_max, qp))
        self._pending_target = target
        self._last_was_i = False
        return int(qp)

    # ------------------------------------------------------------------
    def row_qps(self, base_qp: int, row_mads, is_idr: bool):
        """Basic-unit QP adaptation (G012 with basic unit = one MB row;
        the reference's per-MB hook ``hl_codec_264_rc.c:407`` is compiled
        out, this implements the algorithm it stubs).  ``row_mads``:
        per-MB-row activity of the incoming frame (e.g. mean |src - ref|
        per row).  Rows predicted to need more bits than their share get
        a coarser QP (+-ddquant around the frame QP), which is how G012
        meets the frame target without a within-frame feedback loop."""
        import numpy as _np
        m = _np.asarray(row_mads, _np.float64)
        if is_idr or m.size == 0 or m.sum() <= 0:
            return _np.full(max(m.size, 1), base_qp, _np.int32)
        rel = m / max(m.mean(), 1e-6)
        # qstep scales ~ with the bit overshoot ratio; 6 QP = 2x qstep
        dq = _np.clip(_np.round(6.0 * _np.log2(_np.maximum(rel, 1e-3))
                                / 2.0),
                      -self.ddquant, self.ddquant).astype(_np.int32)
        return _np.clip(base_qp + dq, self.qp_min,
                        self.qp_max).astype(_np.int32)

    # ------------------------------------------------------------------
    def end_frame(self, qp_used: int, bits_used: int, mad: float,
                  is_idr: bool) -> None:
        bits_per_frame = self.bitrate / self.fps
        self.buffer_level += bits_used - bits_per_frame
        self.remaining_bits -= bits_used
        self.frame_in_gop += 1
        mad = max(mad, 1e-3)
        if is_idr:
            self.prev_mad = mad
            return
        self.np_left = max(0, self.np_left - 1)
        self.qp_prev_p = qp_used
        self.sum_p_qp += qp_used
        self.num_p += 1

        # update quadratic R-Q model (sliding window, max 20 points)
        qstep = qp2qstep(qp_used)
        self._rq_win.append((mad, float(bits_used), qstep))
        if len(self._rq_win) > 20:
            self._rq_win.pop(0)
        self._fit_rq()

        # update MAD predictor
        self._mad_win.append((self.prev_mad, mad))
        if len(self._mad_win) > 20:
            self._mad_win.pop(0)
        self._fit_mad()
        self.prev_mad = mad

    # ------------------------------------------------------------------
    def _fit_rq(self) -> None:
        """Least squares for R*Q/MAD = X1 + X2/Q over the window."""
        pts = self._rq_win[-20:]
        if len(pts) == 1:
            mad, bits, q = pts[0]
            self.x1 = bits * q / mad
            self.x2 = 0.0
            return
        sx = sy = sxx = sxy = 0.0
        n = len(pts)
        for mad, bits, q in pts:
            x = 1.0 / q
            y = bits * q / mad
            sx += x
            sy += y
            sxx += x * x
            sxy += x * y
        denom = n * sxx - sx * sx
        if abs(denom) < 1e-12:
            mad, bits, q = pts[-1]
            self.x1 = bits * q / mad
            self.x2 = 0.0
            return
        self.x2 = (n * sxy - sx * sy) / denom
        self.x1 = (sy - self.x2 * sx) / n

    def _fit_mad(self) -> None:
        pts = self._mad_win[-20:]
        if len(pts) < 2:
            if pts:
                prev, cur = pts[0]
                self.mad_a1 = cur / max(prev, 1e-6)
                self.mad_a2 = 0.0
            return
        sx = sy = sxx = sxy = 0.0
        n = len(pts)
        for prev, cur in pts:
            sx += prev
            sy += cur
            sxx += prev * prev
            sxy += prev * cur
        denom = n * sxx - sx * sx
        if abs(denom) < 1e-12:
            self.mad_a1, self.mad_a2 = 1.0, 0.0
            return
        self.mad_a1 = (n * sxy - sx * sy) / denom
        self.mad_a2 = (sy - self.mad_a1 * sx) / n


def guess_best_bitrate(motion_rank: int, width: int, height: int,
                       fps: float) -> int:
    """Reference hl_codec_guess_best_bitrate: rank in {1,2,4} (low/medium/
    high motion), bitrate = w*h*fps*rank*0.07 bps."""
    return int(width * height * fps * motion_rank * 0.07)
