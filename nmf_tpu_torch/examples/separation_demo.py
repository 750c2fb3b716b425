"""Audio source separation demo (the reference paper's application).

Synthesizes a drum-plus-tone mixture, separates it with spectrogram KL-NMF,
and reports how cleanly the components split.

    python -m nmf_tpu_torch.examples.separation_demo [--wav out_prefix] [--device cpu]
"""

from __future__ import annotations

import numpy as np

import nmf_tpu_torch as nt

from ._common import parser, quick, sections


def synth_mixture(sr=16000, seconds=4):
    t = np.arange(sr * seconds) / sr
    # "hi-hat": short noise bursts every 0.25 s
    noise = np.random.RandomState(0).randn(t.size) * 0.3
    gate = ((t * 4) % 1.0) < 0.05
    hats = noise * gate
    # "bass": 110 Hz tone pulsing every 0.5 s
    bass = 0.8 * np.sin(2 * np.pi * 110 * t) * (((t * 2) % 1.0) < 0.4)
    return (hats + bass).astype(np.float32), sr


def main(argv=None, section=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--wav", help="write mixture + sources as WAVs with this prefix")
    ap.add_argument("--rank", type=int, default=4)
    args = ap.parse_args(argv)
    section = sections(section)

    # NMF_TPU_EXAMPLE_QUICK=1 shrinks the clip and the iterations
    audio, sr = synth_mixture(seconds=1 if quick() else 4)
    with section("separate"):
        res = nt.separate(
            audio,
            n_components=args.rank,
            n_fft=1024,
            hop=256,
            config=nt.SolveConfig(max_iter=60 if quick() else 300, thresh=1e-5, check_every=25),
            device=args.device,
        )
        sr_res = res.solve_result
        out = {"separate": {"iterations": int(sr_res.iterations),
                            "num_checks": int(sr_res.num_checks), "cost": float(sr_res.cost),
                            "w": res.w, "h": res.h}}
    print(f"separated into {args.rank} components "
          f"({out['separate']['iterations']} NMF iterations, "
          f"cost {out['separate']['cost']:.4e})")
    # a tonal component concentrates energy at 110 Hz; a percussive one is broadband
    freqs = np.fft.rfftfreq(1024, 1 / sr)
    comps = []
    for i, col in enumerate(res.w.T):
        peak = float(freqs[int(np.argmax(col))])
        spread = float((col > 0.25 * col.max()).mean())
        kind = "tonal" if spread < 0.05 else "broadband"
        comps.append({"peak_hz": peak, "spread": spread, "kind": kind})
        print(f"  component {i}: peak {peak:7.1f} Hz, {kind}")
    out["components"] = comps

    if args.wav:
        from scipy.io import wavfile

        # peak-normalize the mixture like the sources: the synth overlaps
        # exceed [-1, 1] and a raw *32767 cast would WRAP int16 (loud pops)
        mix_peak = max(abs(audio).max(), 1e-9)
        paths = [f"{args.wav}_mix.wav"]
        wavfile.write(paths[0], sr, (audio / mix_peak * 32767).astype(np.int16))
        for i, src in enumerate(res.sources):
            peak = max(abs(src).max(), 1e-9)
            paths.append(f"{args.wav}_src{i}.wav")
            wavfile.write(paths[-1], sr, (src / peak * 32767).astype(np.int16))
        out["wav"] = {"paths": paths}
        print(f"wrote {args.wav}_mix.wav and {args.rank} source files")
    return out


if __name__ == "__main__":
    main()
