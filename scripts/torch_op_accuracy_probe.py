"""Accuracy and time of the port's float32 additive fastsum matvec; the port
of scripts/op_accuracy_probe.py.

The JAX script's problem: n = 1e5 points uniform in d = 10 features and v
normal (default_rng(0)), five 2-D windows [i, i + 1], gaussian (f, l, mu)
= (1, --l 0.5, --mu 0.01), N = 32, psd_clip on every row.  Each row's
relative error is max |y - y_ref| / max |y_ref| against a float64 numpy
NDFT of the same folded math (host_reference_matvec, a copy of the JAX
script's, 2-D windows only), and its time is one matvec (100 calls; host
wall ms, and on the card the card's ms from CUDA events with the calls
queued behind a sleep kernel, and its Mpts/s):

  compensated=False   additive_fastsum_matvec: the table engine, float32
                      phase tables and folded-NDFT products in torch
  compensated=True    the same with the compensated (TwoSum) adjoint
  packed bf16         the main path's operator: packed_ndft_matvec on bf16
                      tables (csrc/packed_ndft_tc.cu on the card; the
                      Nyquist mode trimmed, 2P = N)

The table engine's products run in full float32 on the card because the
package switches TF32 off (__init__.py); so its error is float32's, not
TF32's 10-bit mantissa's.

Limits (ERR_LIMITS; chip_smoke.py [profiles] holds every row to them):
this script's own float32 errors on the CPU at n = 2e4 (n = 2e4, d = 10,
defaults otherwise) were 2.705e-7 (compensated=False), 3.605e-7
(compensated=True) and 1.527e-3 (packed bf16); each limit is 10 x that,
rounded up, for the card's other summation orders and for n = 1e5's longer
sums (float32 sums over n terms err by about sqrt(n) eps: 2.2 x more).

  python scripts/torch_op_accuracy_probe.py                     # the card
  python scripts/torch_op_accuracy_probe.py --platform cpu --n 20000
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, ms_text, time_calls  # noqa: E402

REPS = 100
ERR_LIMITS = {"compensated=False": 3e-6, "compensated=True": 4e-6, "packed bf16": 2e-2}


def host_reference_matvec(Xh, vh, windows_list, l, mu, f, N=32, oversample=2):
    """f64 numpy folded-NDFT additive matvec (same math as ops/fastsum)."""
    n = Xh.shape[0]
    acc = np.zeros(n)
    W = len(windows_list)
    for feats in windows_list:
        Xw = Xh[:, feats]
        c = Xw.mean(0)
        xc = Xw - c
        r = np.sqrt((xc**2).sum(1)).max()
        scale = 0.25 / r if (r > 0.25 or r < 0.125) else 1.0
        x = xc * scale
        Nos = oversample * N
        g = np.fft.fftfreq(Nos, d=1.0 / Nos) / Nos
        gg = np.meshgrid(*([g] * x.shape[1]), indexing="ij")
        r2 = sum(gi * gi for gi in gg) / (scale * scale)
        phi = np.exp(-r2 / (2 * l * l))
        bs = np.real(np.fft.fftshift(np.fft.fftn(phi))) / phi.size
        lo = Nos // 2 - N // 2
        b = bs[(slice(lo, lo + N),) * x.shape[1]]
        b = np.maximum(b, 0.0)  # psd_clip=True parity with the bench
        k = np.arange(N) - N // 2
        # exact NDFT via complex phases (f64)
        if x.shape[1] == 2:
            # y_i = Re sum_kl E0[i,k] E1[i,l] b[k,l] Ahat[k,l]
            E0 = np.exp(-2j * np.pi * np.outer(x[:, 0], k))
            E1 = np.exp(-2j * np.pi * np.outer(x[:, 1], k))
            Ahat = E0.conj().T @ (vh[:, None] * E1.conj())
            y = np.real(np.einsum("ik,kl,il->i", E0, b * Ahat, E1))
        else:
            raise NotImplementedError
        acc += y
    return f * f * (acc / W + mu * vh)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--l", type=float, default=0.5)
    ap.add_argument("--mu", type=float, default=0.01)
    ap.add_argument("--skip-timing", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def make_problem(args):
    """Xh (n, d), vh (n,) in float64 and the window list."""
    rng = np.random.default_rng(0)
    Xh = rng.uniform(size=(args.n, args.d))
    vh = rng.normal(size=(args.n,))
    return Xh, vh, [[i, i + 1] for i in range(0, args.d, 2)]


def matvecs(args, Xh, wlist, device):
    """{row name: float32 matvec v -> y} of the rows."""
    import torch

    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    X = torch.from_numpy(Xh).to(device, torch.float32)
    params = KernelParams.make(1.0, args.l, args.mu, dtype=torch.float32, device=device)
    geom = fs.additive_fastsum_geometry(X, make_windows(wlist))
    plan = fs.additive_fastsum_coeffs("gaussian", params, geom, psd_clip=True)
    pgeom = fs.additive_fastsum_geometry(X, make_windows(wlist), table_dtype=torch.bfloat16)
    pn = fs.packed_ndft_plan(fs.additive_fastsum_coeffs("gaussian", params, pgeom, psd_clip=True),
                             table_dtype=torch.bfloat16)
    return {"compensated=False": lambda v: fs.additive_fastsum_matvec(plan, v, compensated=False),
            "compensated=True": lambda v: fs.additive_fastsum_matvec(plan, v, compensated=True),
            "packed bf16": lambda v: fs.packed_ndft_matvec(pn, v)}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    device = device_of(args.platform, "torch_op_accuracy_probe")
    label = card_label(device)
    print(f"[device] {label}", flush=True)
    Xh, vh, wlist = make_problem(args)
    print("building f64 host reference...", flush=True)
    y_ref = host_reference_matvec(Xh, vh, wlist, args.l, args.mu, 1.0)
    den = np.abs(y_ref).max()
    v = torch.from_numpy(vh).to(device, torch.float32)
    out = {"n": args.n, "d": args.d, "l": args.l, "mu": args.mu, "device": label, "reps": REPS,
           "limits": ERR_LIMITS, "rows": {}}
    for name, mv in matvecs(args, Xh, wlist, device).items():
        y = mv(v).double().cpu().numpy()
        rec = {"rel_err": float(np.abs(y - y_ref).max() / den)}
        text = f"{name}: rel err {rec['rel_err']:.3e} (limit {ERR_LIMITS[name]:.0e})"
        if not args.skip_timing:
            t = time_calls(lambda mv=mv: mv(v), REPS, device)
            ms = t["card_ms"] if t["card_ms"] is not None else t["host_ms"]
            rec.update(t, mpts_per_s=args.n / ms / 1e3)
            text += (f"  matvec {ms_text(t)} ({rec['mpts_per_s']:.0f} Mpts/s by the "
                     f"{'card' if t['card_ms'] is not None else 'host'}'s time)")
        out["rows"][name] = rec
        print(f"{text} | {label}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
