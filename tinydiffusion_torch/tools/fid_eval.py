"""FID of pixel-space and latent diffusion checkpoints' samplers, on the card.

    python -m tinydiffusion_torch.tools.fid_eval --checkpoint checkpoints/diffusion_final \
        --variants ddpm,ddim50,dpmpp20 --n 4096 [--device cpu]

Counterpart of ``tools/fid_eval.py``, with its flags and ``--device``. The
feature net is restored from ``--classifier`` (JAX's committed
``checkpoints/fid_classifier``); it is trained (3 epochs) and saved there
only when that path holds no checkpoint. The real set's Gaussian comes from
the 10 000 test images; each sampler variant draws ``--n`` samples in
batches of ``--sample-batch`` and is scored against it.

Variant grammar: ``ddpm`` (the 1000-step ancestral chain), ``ddimK``,
``dpmppK`` (DPM-Solver++(2M)), each with an optional ``-bf16`` suffix for a
bfloat16 chain. The model's forward dtype does not follow the suffix: the
UNet28 runs in bfloat16 as ``generate.py`` serves it, a latent denoiser in
its checkpoint's ``compute_dtype``.

Calibration rows: ``real-train`` (``--n`` train images against the test set,
the floor a perfect sampler reaches at this n) and ``noise`` (N(0, 1)
images, the ceiling), drawn from ``np.random.default_rng(seed)`` in JAX's
order, so they equal JAX's numbers. A conditional checkpoint's rows also
report ``label_acc``, how often the classifier reads the requested digit;
its labels and the chains' noise come from one ``torch.Generator`` seeded
with ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_variant(token: str) -> tuple[str, int, str]:
    """'ddpm' | 'ddimK' | 'dpmppK', optionally ending in '-bf16' ->
    (method, steps, dtype name)."""
    dtype = "float32"
    if token.endswith("-bf16"):
        token, dtype = token[: -len("-bf16")], "bfloat16"
    if token == "ddpm":
        return "ddpm", 0, dtype
    for method, default_steps in (("dpmpp", 20), ("ddim", 50)):
        if token.startswith(method):
            steps = int(token[len(method):] or default_steps)
            if steps < 1:
                raise ValueError(f"{method} steps must be >= 1, got {steps}")
            return method, steps, dtype
    raise ValueError(f"unknown sampler variant {token!r}")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--classifier", default="checkpoints/fid_classifier",
                        help="feature-net checkpoint; trained here if absent")
    parser.add_argument("--variants", default="ddpm,ddim50",
                        help="comma list: ddpm | ddimK | dpmppK, optional -bf16 suffix")
    parser.add_argument("--n", type=int, default=4096, help="generated samples per variant")
    parser.add_argument("--sample-batch", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data-root", default="./data")
    parser.add_argument("--guidance-scale", type=float, default=1.0)
    parser.add_argument("--json-out", default=None,
                        help="also append one JSON line per row here")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from tinydiffusion_torch.data.mnist import load_mnist
    from tinydiffusion_torch.device import disable_tf32, resolve_device
    from tinydiffusion_torch.eval.fid import (
        FeatureNet,
        classifier_accuracy,
        featurize,
        fid_from_stats,
        frechet_gaussian_stats,
        load_feature_net,
        save_feature_net,
        train_feature_net,
    )
    from tinydiffusion_torch.experiments.common import (
        load_latent_checkpoint,
        load_pixel_checkpoint,
        make_latent_pixel_sampler,
        make_sampler,
        resolve_dtype,
    )
    from tinydiffusion_torch.io.checkpoint import load_sidecar, weights_exist

    variants = [parse_variant(v) for v in args.variants.split(",") if v]
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()

    # --- feature net: restore, or train once and save -------------------
    x_train, y_train = load_mnist(args.data_root, train=True)
    x_test, y_test = load_mnist(args.data_root, train=False)
    if weights_exist(args.classifier):
        model = load_feature_net(args.classifier, FeatureNet()).to(device).eval()
        print(f"loaded feature net from {args.classifier}")
    elif os.path.exists(args.classifier):
        parser.error(f"{args.classifier} is a checkpoint without its .npz weights (a JAX Orbax "
                     "directory?); refusing to train over it")
    else:
        print("training feature net (3 epochs)...")
        model = train_feature_net(x_train, y_train, device=device)
        acc = classifier_accuracy(model, x_test, y_test)
        save_feature_net(args.classifier, model, config={"feature_dim": model.feature_dim},
                         metadata={"test_accuracy": acc})
        print(f"feature net test accuracy {acc:.4f} -> {args.classifier}")

    t0 = time.perf_counter()
    real_stats = frechet_gaussian_stats(featurize(model, x_test))
    featurize_real_s = time.perf_counter() - t0

    rows: list[dict] = []

    def report(name: str, feats: np.ndarray, label_acc: float | None = None) -> None:
        fid = fid_from_stats(*real_stats, *frechet_gaussian_stats(feats))
        row = {"variant": name, "fid": round(fid, 4), "n": args.n,
               "guidance_scale": args.guidance_scale}
        acc_txt = ""
        if label_acc is not None:
            row["label_acc"] = round(label_acc, 4)
            acc_txt = f"   label-acc {label_acc:6.1%}"
        rows.append(row)
        print(f"  {name:<16s} FID {fid:8.3f}{acc_txt}")

    # Calibration rows: FID of perfect and of garbage samples at this n.
    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(len(x_train))[: args.n]
    print(f"FID vs {len(x_test)} held-out real images (feature dim {model.feature_dim}):")
    report("real-train", featurize(model, x_train[idx]))
    report("noise", featurize(
        model, rng.standard_normal((args.n, 28, 28, 1)).astype(np.float32)))

    # --- sampler variants ------------------------------------------------
    # A sidecar with 'backbone' marks a latent checkpoint (latent chain and
    # the VAE's decode); a pixel checkpoint samples directly.
    is_latent = "backbone" in load_sidecar(args.checkpoint).get("config", {})
    if is_latent:
        if args.guidance_scale != 1.0:
            parser.error("--guidance-scale applies to pixel CFG checkpoints")
        loaded = load_latent_checkpoint(args.checkpoint, device=device)
        conditional = True
    else:
        loaded = load_pixel_checkpoint(args.checkpoint, device)
        conditional = loaded["conditional"]
    print(f"loaded {args.checkpoint} (step {loaded['step']})")

    batch = args.sample_batch
    sample_s = {}
    for method, steps, dtype_name in variants:
        name = (f"{method}{steps if method != 'ddpm' else ''}"
                + ("-bf16" if dtype_name == "bfloat16" else ""))
        if is_latent:
            latent_fn = make_latent_pixel_sampler(loaded, batch, method=method,
                                                  sample_steps=steps,
                                                  dtype=resolve_dtype(dtype_name))

            def sampler(generator, y, _fn=latent_fn):
                return _fn(generator, y)
        else:
            pixel_fn = make_sampler(
                loaded["model"], loaded["schedule"], (batch, 1, 28, 28),
                conditional=conditional, dtype=resolve_dtype(dtype_name), method=method,
                sample_steps=steps, guidance_scale=args.guidance_scale,
                null_label=loaded["num_classes"] if loaded["cfg_trained"] else None,
                prediction=loaded["cfg"].get("prediction", "eps"),
                compute_dtype=torch.bfloat16)

            def sampler(generator, y, _fn=pixel_fn):
                return _fn(generator, params=loaded["params"], y=y)

        generator = torch.Generator(device).manual_seed(args.seed)
        chunks, ys = [], []
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(0, args.n, batch):
            y = None
            if conditional:
                y = torch.randint(0, loaded["num_classes"], (batch,), generator=generator,
                                  device=device)
                ys.append(y.cpu().numpy())
            chunks.append(sampler(generator, y).float().permute(0, 2, 3, 1).cpu().numpy())
        sample_s[name] = time.perf_counter() - t0
        gen = np.clip(np.concatenate(chunks)[: args.n], -1.0, 1.0)
        # A conditional checkpoint: how often the classifier reads the
        # requested class, the fidelity axis FID cannot see.
        label_acc = (classifier_accuracy(model, gen, np.concatenate(ys)[: args.n])
                     if conditional else None)
        report(name, featurize(model, gen), label_acc)

    if args.json_out:
        with open(args.json_out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return {"rows": rows, "featurize_real_s": featurize_real_s, "sample_s": sample_s}


if __name__ == "__main__":
    main()
