"""Command-line GP training and prediction, the TEST4 program (port of cli.py).

Mirrors the reference's TEST4 program (ref TESTS/TEST4/foo.cpp:136-160): feature,
label and window files in the reference's text formats, Adam training,
prediction RMSE and the loss-history / prediction dumps (foo.cpp:401-432).
Same flags and outputs as the JAX package's CLI; it runs on the CUDA device
unless --platform cpu is given, and fails where there is no card.

Usage:
  python -m preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch.cli \\
      --data-dir TESTS/TEST4/data --name poletele --kernel gaussian \\
      --window g --adam-maxits 20 --operator fastsum
"""

import argparse
import os
import time


def build_argparser():
    ap = argparse.ArgumentParser(description="NFFT4GP GP trainer (PyTorch)")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--name", required=True, help="dataset prefix, e.g. poletele")
    ap.add_argument("--kernel", default="gaussian", choices=["gaussian", "matern32", "matern12"])
    ap.add_argument("--window", default="g", help="window suffix (g/m) or 'none'")
    ap.add_argument("--operator", default="fastsum", choices=["dense", "fastsum"])
    ap.add_argument("--precond", default="nystrom", choices=["none", "chol", "nystrom", "fsai", "afn"])
    ap.add_argument("--ntrain", type=int, default=0, help="0 = all")
    ap.add_argument("--ntest", type=int, default=0)
    ap.add_argument("--f", type=float, default=1.0)
    ap.add_argument("--l", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--adam-maxits", type=int, default=500)
    ap.add_argument("--adam-alpha", type=float, default=0.01)
    ap.add_argument("--learn-maxits", type=int, default=10)
    ap.add_argument("--learn-nvecs", type=int, default=10)
    ap.add_argument("--rank", type=int, default=50)
    ap.add_argument("--lfil", type=int, default=20)
    ap.add_argument("--fastsum-N", type=int, default=32)
    ap.add_argument("--fastsum-oversample", type=int, default=2)
    ap.add_argument("--fastsum-nearfield-lfil", type=int, default=None,
                    help="sparse near-field correction size; default auto (16 for matern12, 0 otherwise)")
    ap.add_argument("--fastsum-table-dtype", default=None, choices=["bfloat16"],
                    help="narrow NDFT phase tables during training")
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--x64", action="store_true", help="double precision (CPU parity)")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="device to run on (default cuda)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np
    import torch

    from .io import read_features, read_labels, read_windows
    from .models.problem import GPProblem
    from .models.transforms import transform_forward, transform_inverse

    device = torch.device(args.platform or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --platform cpu to run on the CPU")
    dtype = torch.float64 if args.x64 else torch.float32

    dd, nm = args.data_dir, args.name
    Xtr = read_features(os.path.join(dd, f"{nm}.train.feature"))
    ytr = read_labels(os.path.join(dd, f"{nm}.train.label"))
    Xte = read_features(os.path.join(dd, f"{nm}.test.feature"))
    yte = read_labels(os.path.join(dd, f"{nm}.test.label"))
    if args.ntrain:
        Xtr, ytr = Xtr[: args.ntrain], ytr[: args.ntrain]
    if args.ntest:
        Xte, yte = Xte[: args.ntest], yte[: args.ntest]

    windows = None
    if args.window != "none":
        warr = read_windows(os.path.join(dd, f"{nm}.{args.window}.window"))
        windows = [[int(f) for f in row if f >= 0] for row in warr]

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    Xtr_t, ytr_t, Xte_t = tensor(Xtr), tensor(ytr), tensor(Xte)
    prob = GPProblem(
        kernel=args.kernel, windows=windows, operator=args.operator, precond=args.precond,
        rank=args.rank, lfil=args.lfil, maxits=args.learn_maxits, nvecs=args.learn_nvecs,
        fastsum_N=args.fastsum_N, fastsum_table_dtype=args.fastsum_table_dtype,
        fastsum_oversample=args.fastsum_oversample,
        fastsum_nearfield_lfil=args.fastsum_nearfield_lfil,
    )
    print(f"n_train={Xtr.shape[0]} n_test={Xte.shape[0]} d={Xtr.shape[1]} "
          f"windows={windows} kernel={args.kernel} operator={args.operator} "
          f"precond={args.precond}")

    t0 = time.time()
    if args.adam_maxits > 0:
        prob.fit(Xtr_t, ytr_t, init=(args.f, args.l, args.mu), adam_maxits=args.adam_maxits,
                 adam_alpha=args.adam_alpha, verbose=True)
    else:
        prob.raw_params_ = transform_inverse("softplus", tensor([args.f, args.l, args.mu]))
    t_train = time.time() - t0

    t0 = time.time()
    mean = prob.predict(Xtr_t, ytr_t, Xte_t)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_pred = time.time() - t0

    rmse = float(torch.sqrt(torch.mean((mean - tensor(yte)) ** 2)))
    tv, _ = transform_forward("softplus", prob.raw_params_)
    print(f"final params (after transform): f={float(tv[0]):.6g} "
          f"l={float(tv[1]):.6g} mu={float(tv[2]):.6g}")
    print(f"prediction RMSE: {rmse:.6g}  (train {t_train:.1f}s, predict {t_pred:.1f}s)")

    if args.out_prefix:
        np.savetxt(f"{args.out_prefix}_pred.txt",
                   np.stack([np.asarray(yte), mean.detach().cpu().numpy()], axis=1),
                   header="Label Predict", comments="")
        if prob.loss_history_:
            np.savetxt(f"{args.out_prefix}_loss.txt", np.asarray(prob.loss_history_))
    return rmse


if __name__ == "__main__":
    main()
