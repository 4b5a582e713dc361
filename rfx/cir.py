"""Channel-impulse-response assembly and RX-power metrics (on-device).

The reference accumulates the CIR on the host in a Python loop over paths
(ref tracer.py:101-117) and derives RX power by convolving with a carrier
sine on the CPU (ref main.py:46-55). Both run here as vectorised XLA ops:
binning is a scatter-add (atomic on the GPU, so its summation order, and the
last bits of a bin, change from run to run: compare IRs with a tolerance),
the convolution a `lax.conv` at HIGHEST precision whose nonzero-sample
selection is held to the structural support of the IR (see rx_power_dbm).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["bin_impulse_response", "cir_from_trace", "rx_power_dbm", "rx_power_dbm_phasor", "to_dbm"]

def bin_impulse_response(
    amplitude: jnp.ndarray,
    distance: jnp.ndarray,
    captured: jnp.ndarray,
    *,
    nbins: int,
    light_speed_mps: float,
    sample_rate_hz: float,
    soft: bool = False,
):
    """Scatter per-path amplitudes into delay bins.

    Hard mode reproduces the reference exactly: bin = int(distance/c * rate)
    (truncation, ref tracer.py:115), out-of-window paths dropped, amplitudes
    summed. Soft mode linearly splits each amplitude between the two
    neighbouring bins so d(IR)/d(distance) is nonzero — required for delay
    gradients in the inverse solve (hard binning is piecewise constant).

    Paths outside the window (and uncaptured rays) are sent to index
    `nbins`, which the scatter drops: they never contend for a real bin's
    atomic add.
    """
    delay = distance / light_speed_mps * sample_rate_hz
    amp = jnp.where(captured, amplitude, 0.0)

    def add(ir, bins, valid, weight):
        return ir.at[jnp.where(valid, bins, nbins)].add(weight, mode="drop")

    ir = jnp.zeros((nbins,), amp.dtype)
    if soft:
        lo = jnp.floor(delay)
        w = delay - lo
        lo_i = lo.astype(jnp.int32)
        valid_lo = captured & (lo_i >= 0) & (lo_i < nbins)
        valid_hi = captured & (lo_i + 1 >= 0) & (lo_i + 1 < nbins)
        ir = add(ir, lo_i, valid_lo, amp * (1.0 - w))
        return add(ir, lo_i + 1, valid_hi, amp * w)
    bins = delay.astype(jnp.int32)  # truncation toward zero, matches int()
    valid = captured & (bins >= 0) & (bins < nbins)
    return add(ir, bins, valid, amp)


def cir_from_trace(
    result,
    *,
    tx_power,
    num_rays: int,
    nbins: int,
    light_speed_mps: float,
    sample_rate_hz: float,
    soft: bool = False,
):
    """TraceResult -> impulse response. Per-path amplitude starts at
    tx_power / N (ref tracer.py:103) times the accumulated Fresnel product."""
    amp = result.amplitude * (tx_power / num_rays)
    return bin_impulse_response(
        amp,
        result.distance,
        result.captured,
        nbins=nbins,
        light_speed_mps=light_speed_mps,
        sample_rate_hz=sample_rate_hz,
        soft=soft,
    )


def to_dbm(power):
    return 10.0 * jnp.log10(power / 1e-3)


@partial(jax.jit, static_argnames=("carrier_hz", "sample_window_s"))
def rx_power_dbm(
    impulse_response: jnp.ndarray,
    sample_window_s: float,
    carrier_hz: float = 2.4e9,
):
    """Reference RX-power metric (ref main.py:46-55): convolve the IR with a
    carrier sine ('same' mode), mean-square over nonzero samples, dBm.

    Accepts (nbins,) or a batched (M, nbins) IR (the coverage engine).
    Returns -inf dBm where nothing was received.

    The mean runs over output samples that are nonzero AND inside the IR's
    structural support (samples some nonzero bin reaches through the kernel
    window). On the CPU the direct convolution leaves every sample outside
    it exactly zero, so the mask changes nothing; a GPU convolution
    algorithm (FFT, Winograd) may leave roundoff there instead, which the
    mask keeps out of the count.
    """
    squeeze = impulse_response.ndim == 1
    ir = jnp.atleast_2d(impulse_response)
    m, nbins = ir.shape
    t = jnp.linspace(0.0, sample_window_s, nbins)
    kernel = jnp.sin(2.0 * jnp.pi * carrier_hz * t)

    # np.convolve(a, k, mode='same') == full conv trimmed to start at
    # (len(k)-1)//2. Express as lax.conv with explicit padding.
    lhs = ir[:, None, :]  # (M, 1, nbins)
    rhs = kernel[::-1][None, None, :]  # flip: convolution, not correlation
    lo = (nbins - 1) // 2
    hi = nbins - 1 - lo
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1,),
        padding=[(nbins - 1 - lo, nbins - 1 - hi)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :]
    # 'same' trimming: np takes indices [lo, lo+nbins) of the full conv; the
    # padding above already yields exactly nbins outputs starting at lo, and
    # out[n] = sum_k ir[k] * kernel[n + lo - k]: bin k reaches outputs
    # [k - lo, k - lo + nbins - 1].
    idx = jnp.arange(nbins)
    nzk = ir != 0.0
    k_first = jnp.min(jnp.where(nzk, idx, nbins), axis=1, keepdims=True)
    k_last = jnp.max(jnp.where(nzk, idx, -1), axis=1, keepdims=True)
    support = (idx >= k_first - lo) & (idx <= k_last - lo + nbins - 1)
    nz = (out != 0.0) & support
    count = jnp.sum(nz, axis=1)
    power = jnp.where(
        count > 0, jnp.sum(jnp.where(nz, out**2, 0.0), axis=1) / jnp.maximum(count, 1), 0.0
    )
    dbm = jnp.where(count > 0, to_dbm(jnp.maximum(power, 1e-300)), -jnp.inf)
    if squeeze:
        return dbm[0], out[0]
    return dbm, out


def rx_power_dbm_phasor(
    amplitude: jnp.ndarray,
    distance: jnp.ndarray,
    captured: jnp.ndarray,
    *,
    sample_window_s: float,
    nbins: int,
    light_speed_mps: float,
    sample_rate_hz: float,
    carrier_hz: float = 2.4e9,
    return_cancellation: bool = False,
):
    """RX power WITHOUT materializing the impulse response.

    The reference metric convolves the sparse IR with a single-frequency
    carrier sine and takes the mean square over nonzero samples
    (ref main.py:46-55). A superposition of same-frequency sinusoids is one
    sinusoid: signal[n] ~ Im(A e^{i w t_n}) with A = sum_k ir[k] e^{-i w t_k},
    so mean(signal^2) ~ |A|^2 / 2 exactly, up to 'same'-mode edge truncation
    (sub-0.2 dB when path delays sit well inside the window; validated
    against the exact path in tests). This turns the coverage engine's
    per-receiver scatter-add into a pure reduction.

    Delay quantization matches the binned IR exactly: bin = int(d/c * rate),
    t_k = bin * window/(nbins-1) (the exact metric's linspace grid).
    Out-of-window paths are dropped like the binning path. Returns dBm
    (-inf when nothing was captured).
    """
    delay_bins = (distance / light_speed_mps * sample_rate_hz).astype(jnp.int32)
    valid = captured & (delay_bins >= 0) & (delay_bins < nbins)
    amp = jnp.where(valid, amplitude, 0.0)
    t_k = delay_bins.astype(jnp.float32) * (sample_window_s / (nbins - 1))
    phase = 2.0 * jnp.pi * carrier_hz * t_k
    # Truncation model: a spike at bin k only excites output samples
    # [max(k-lo, 0), min(k+hi, nbins-1)] of the 'same' convolution — support
    # s_k = min(k + hi + 1, nbins) for k < lo. Weight each phasor by
    # sqrt(s_k) (min(s_i, s_j) ~ sqrt(s_i s_j) for clustered delays) and
    # normalize by the union support, so the mean-over-nonzero-samples
    # semantics of the exact metric carry over.
    hi = nbins - 1 - (nbins - 1) // 2
    s_k = jnp.where(valid, jnp.minimum(delay_bins + hi + 1, nbins).astype(jnp.float32), 0.0)
    w_k = jnp.sqrt(s_k)
    a_re = jnp.sum(amp * w_k * jnp.cos(phase))
    a_im = jnp.sum(amp * w_k * jnp.sin(phase))
    n_nz = jnp.maximum(jnp.max(s_k), 1.0)
    power = 0.5 * (a_re * a_re + a_im * a_im) / n_nz
    any_hit = jnp.any(valid)
    dbm = jnp.where(any_hit, to_dbm(jnp.maximum(power, 1e-300)), -jnp.inf)
    if not return_cancellation:
        return dbm
    # Cancellation diagnostic: coherent |A|^2 over the incoherent sum of the
    # same weighted phasors. Near 1 when one arrival dominates or phases
    # align; << 1 under destructive interference — exactly the regime where
    # the single-phasor model's 'same'-convolution truncation error blows up
    # (each spike's truncated sinusoid tail survives cancellation that the
    # phasor sum assumes; up to 20 dB was measured there).
    incoherent = jnp.sum((amp * w_k) ** 2)
    ratio = (a_re * a_re + a_im * a_im) / jnp.maximum(incoherent, 1e-300)
    ratio = jnp.where(any_hit, ratio, 1.0)
    # Power-weighted delay spread (seconds): the second failure mode of the
    # single-support phasor model is well-SEPARATED spikes (the sqrt(s_i s_j)
    # cross-term support approximation degrades as spikes move apart), which
    # shows up even without cancellation. Both diagnostics feed the hybrid's
    # exact-fallback decision (rfx.coverage.coverage_dbm_hybrid).
    wgt = (amp * w_k) ** 2
    wsum = jnp.maximum(jnp.sum(wgt), 1e-300)
    t_mean = jnp.sum(wgt * t_k) / wsum
    spread = jnp.sqrt(jnp.maximum(jnp.sum(wgt * (t_k - t_mean) ** 2) / wsum, 0.0))
    spread = jnp.where(any_hit, spread, 0.0)
    return dbm, ratio, spread
