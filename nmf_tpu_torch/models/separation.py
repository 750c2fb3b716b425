"""Audio source separation by spectrogram NMF: the reference's application.

Counterpart of ``nmf_tpu.models.separation``.  The reference library exists
to speed up this pipeline (ISMIR 2009): the magnitude STFT of the audio,
KL-NMF into K spectral basis vectors (columns of W) and their activations
(rows of H), one Wiener mask per component, and the inverse STFT back to
audio.  The paper's workload is 20 s at 44.1 kHz, a 1024-point FFT and hop
256: X of 513 x 3446.

The NMF runs on the card through :func:`~nmf_tpu_torch.solve` (or
:func:`~nmf_tpu_torch.solve_semi` with frozen templates), so through the
kernels K1-K3; the STFT, the Wiener masks and the ISTFT are host-side NumPy
(``_stft_np``, ``_istft_np``, ``_masked_sources``), as in JAX.
:func:`stft` and :func:`istft` are the torch versions for on-device
pipelines (on ``device``, ``"cuda"`` by default, as every entry point of the
port): ``torch.fft`` with the periodic Hann window, and an overlap-add
that sums the frames in a fixed order (slices added one frame phase at a
time: ``index_add_`` is atomic on the card, and its bits would change from
run to run).

``n_restarts > 1`` runs the restarts in one batched solve
(:func:`~nmf_tpu_torch.solve_restarts`) and keeps the lowest cost; with
templates, each member re-seeds only the free columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.config import SolveConfig
from ..utils.device import resolve_device
from .init import scaled_random_init
from .solver import SolveResult, solve

__all__ = ["stft", "istft", "SeparationResult", "separate"]


def _hann_np(n: int) -> np.ndarray:
    """The periodic Hann window (COLA at hop = n/4), in f32."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(audio, n_fft: int = 1024, hop: int = 256, device="cuda") -> torch.Tensor:
    """Complex STFT of mono ``audio`` (a tensor or an array, moved to
    ``device``): frames of ``n_fft`` samples every ``hop``, centred by
    ``n_fft // 2`` of zero padding, Hann-windowed.  Returns
    (n_fft // 2 + 1, n_frames) on ``device``."""
    audio = torch.as_tensor(audio, dtype=torch.float32, device=resolve_device(device))
    pad = n_fft // 2
    x = torch.nn.functional.pad(audio, (pad, pad))
    frames = x.unfold(0, n_fft, hop) * torch.from_numpy(_hann_np(n_fft)).to(x.device)
    return torch.fft.rfft(frames, dim=1).T          # (bins, frames)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum (F, n) frames placed every ``hop`` samples: (n + hop (F - 1),).

    The frames are cut into ``ceil(n / hop)`` phases of ``hop`` samples and
    each phase is added as one slice, the last phase first: every output
    sample sums its frames in ascending frame order, as the host loop of
    ``_istft_np`` does, with no atomics.
    """
    n_frames, n = frames.shape
    r = -(-n // hop)
    frames = torch.nn.functional.pad(frames, (0, r * hop - n)).reshape(n_frames, r, hop)
    out = torch.zeros((n_frames + r - 1, hop), dtype=frames.dtype, device=frames.device)
    for j in reversed(range(r)):
        out[j:j + n_frames] += frames[:, j]
    return out.reshape(-1)[: n + hop * (n_frames - 1)]


def istft(
    spec, n_fft: int = 1024, hop: int = 256, length: Optional[int] = None, device="cuda"
) -> torch.Tensor:
    """Inverse of :func:`stft` on ``device`` (``spec`` is moved there):
    windowed overlap-add, normalised by the summed squared window."""
    spec = torch.as_tensor(spec, device=resolve_device(device))
    win = torch.from_numpy(_hann_np(n_fft)).to(spec.device)
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=1).to(torch.float32) * win
    out = _overlap_add(frames, hop)
    norm = _overlap_add((win * win).expand(frames.shape[0], n_fft), hop)
    out = (out / torch.clamp_min(norm, 1e-8))[n_fft // 2:]
    return out if length is None else out[:length]


# Host-side NumPy STFT, ISTFT and Wiener masking, used by separate(): the
# JAX package's own code, so both packages give the same spectrogram.


def _stft_np(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Host-side STFT, numerically equivalent to :func:`stft`."""
    pad = n_fft // 2
    x = np.pad(audio.astype(np.float32), (pad, pad))
    n_frames = 1 + (x.shape[0] - n_fft) // hop
    win = _hann_np(n_fft)
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * win[None, :]
    return np.fft.rfft(frames, axis=1).astype(np.complex64).T  # (bins, frames)


def _istft_np(spec: np.ndarray, n_fft: int, hop: int, length: Optional[int] = None) -> np.ndarray:
    """Host-side ISTFT (windowed overlap-add), equivalent to :func:`istft`."""
    frames = np.fft.irfft(spec.T, n=n_fft, axis=1).astype(np.float32)
    win = _hann_np(n_fft)
    frames *= win[None, :]
    n_frames = frames.shape[0]
    total = n_fft + hop * (n_frames - 1)
    out = np.zeros((total,), np.float32)
    norm = np.zeros((total,), np.float32)
    w2 = win * win
    for f in range(n_frames):
        out[f * hop: f * hop + n_fft] += frames[f]
        norm[f * hop: f * hop + n_fft] += w2
    out /= np.maximum(norm, 1e-8)
    out = out[n_fft // 2:]
    return out[:length] if length is not None else out


def _masked_sources(
    w: np.ndarray, h: np.ndarray, spec: np.ndarray, n_fft: int, hop: int, length: int
) -> np.ndarray:
    """All K Wiener-masked sources, one (bins, frames) mask at a time (all K
    masked spectrograms at once would take K times the clip's)."""
    w = np.asarray(w, np.float32)
    h = np.asarray(h, np.float32)
    recon = np.maximum(w @ h, 1e-12)                      # (bins, frames)
    out = []
    for k_i in range(w.shape[1]):
        comp = w[:, k_i: k_i + 1] @ h[k_i: k_i + 1, :]
        masked = (spec * (comp / recon)).astype(np.complex64)
        out.append(_istft_np(masked, n_fft, hop, length))
    return np.stack(out)


@dataclasses.dataclass
class SeparationResult:
    """K separated sources and the factorization that produced them."""

    sources: np.ndarray          # (K, samples) per-component audio
    w: np.ndarray                # (bins, K) spectral dictionary
    h: np.ndarray                # (K, frames) activations
    solve_result: SolveResult


def separate(
    audio,
    n_components: int = 32,
    n_fft: int = 1024,
    hop: int = 256,
    config: Optional[SolveConfig] = None,
    seed: int = 0,
    n_restarts: int = 1,
    w_template=None,
    adapt_template: bool = False,
    device="cuda",
) -> SeparationResult:
    """Decompose mono ``audio`` into ``n_components`` sources: magnitude STFT,
    KL-NMF on ``device`` (``"cuda"`` by default) from
    ``scaled_random_init(seed)``, the Wiener mask ``(w_k h_k) / (W H)`` on
    the complex STFT, ISTFT.

    ``w_template`` ((n_fft // 2 + 1, F) spectral templates, e.g. drum basis
    vectors learned from solo recordings) seeds the FIRST F components and
    freezes them while the other ``n_components - F`` adapt
    (:func:`~nmf_tpu_torch.solve_semi`); ``sources[:F]`` are then the
    template stems.  ``adapt_template=True`` lets the templates train too.
    The default config is 200 iterations, ``thresh=1e-5``, a check every 25.
    ``n_restarts > 1`` keeps the lowest-cost of that many seeded solves
    (seeds ``seed``, ``seed + 1``, ...), run as one batched solve.
    """
    if n_restarts < 1:
        raise ValueError(f"n_restarts must be >= 1, got {n_restarts}")
    audio = np.asarray(audio, np.float32)
    if audio.ndim != 1:
        raise ValueError("separate() expects mono audio (1-D)")
    config = config or SolveConfig(max_iter=200, thresh=1e-5, check_every=25)

    spec = _stft_np(audio, n_fft, hop)        # complex (bins, frames), host
    mag = np.abs(spec).astype(np.float32)
    if w_template is not None:
        from .semi import solve_semi

        w_template = np.asarray(w_template, np.float32)
        n_bins = n_fft // 2 + 1
        if w_template.ndim != 2 or w_template.shape[0] != n_bins:
            raise ValueError(
                f"w_template must be ({n_bins}, F) for n_fft={n_fft}, got "
                f"{w_template.shape}"
            )
        f = w_template.shape[1]
        if f > n_components:
            raise ValueError(f"{f} template columns exceed n_components={n_components}")
        if n_restarts > 1:
            # restart only the FREE columns: the templates frozen, each
            # member re-seeding the rest (selection's n_frozen)
            from .selection import solve_restarts

            inits = [scaled_random_init(mag, n_components, seed=seed + s)
                     for s in range(n_restarts)]
            w0s = np.stack([np.concatenate([w_template, w[:, f:]], axis=1) for w, _ in inits])
            h0s = np.stack([h for _, h in inits])
            res = solve_restarts(mag, w0s=w0s, h0s=h0s, config=config,
                                 n_frozen=0 if adapt_template else f,
                                 device=device).best_solve_result()
        else:
            w_rand, h0 = scaled_random_init(mag, n_components, seed=seed)
            w0 = np.concatenate([w_template, w_rand[:, f:]], axis=1)
            res = solve_semi(mag, w0, h0, config, n_frozen=0 if adapt_template else f,
                             device=device)
    elif n_restarts > 1:
        from .selection import solve_restarts

        res = solve_restarts(mag, rank=n_components, n_restarts=n_restarts, config=config,
                             seed=seed, device=device).best_solve_result()
    else:
        w0, h0 = scaled_random_init(mag, n_components, seed=seed)
        res = solve(mag, w0, h0, config, device=device)
    w, h = (t.detach().cpu().float().numpy() for t in (res.w, res.h))
    sources = _masked_sources(w, h, spec, n_fft, hop, int(audio.shape[0]))
    return SeparationResult(sources=sources, w=w, h=h, solve_result=res)
