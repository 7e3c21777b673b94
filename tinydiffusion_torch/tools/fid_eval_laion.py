"""FID for the LAION 256² pair: the conv-VAE and sample dumps, on the card.

    python -m tinydiffusion_torch.tools.fid_eval_laion [--samples-dir DIR] [--device cpu]

Counterpart of ``tools/fid_eval_laion.py``, with its flags and ``--device``.
The features come from an RGB ``FeatureNet`` trained on the 4 caption
classes of the synthetic LAION records (``data/laion.py``), restored from
``--classifier`` (default ``checkpoints/fid_classifier_rgb<size>``, JAX's
committed net at 256) and trained and saved there only when absent. Rows,
each against the real set (``--n`` synthetic images):

- ``calibration_floor_real_vs_real``: a second, disjoint real set;
- ``calibration_ceiling_real_vs_noise``: uniform noise images from
  ``np.random.default_rng(seed)``, JAX's draw;
- ``vae_recon`` and ``vae_prior_decode``: the conv-VAE's reconstructions and
  prior samples (``experiments/vae_laion.py``: ``reconstruct``,
  ``sample_prior``) in batches of ``--batch``, its attention through the
  CUDA flash forward on a card; the noise from one ``torch.Generator``
  seeded ``seed + 1`` (each batch: eps, then the prior's z);
- ``samples_dir[n]``: the PNGs in ``--samples-dir`` (say, a
  ``generate_laion.py --dump-dir``), read as RGB and resized to
  ``--image-size`` as Pillow's ``convert("RGB").resize`` does.

The values are not Inception FIDs; relative comparisons and the floor and
ceiling rows are the point.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np


def rgb_channels(size: int) -> tuple[int, ...]:
    """Conv/pool blocks until the side reaches 8 (256 -> 5 blocks)."""
    blocks = max(2, (size // 8).bit_length() - 1)
    return (32, 64, 128, 128, 128, 128, 128)[:blocks]


def synth_set(n: int, size: int, offset: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 images (n, size, size, 3), int32 labels), deterministic;
    ``offset`` shifts the index range for disjoint splits (i % 4 keeps the
    classes balanced at any multiple-of-4 offset)."""
    from tinydiffusion_torch.data.laion import synthesize_image

    xs = np.stack([synthesize_image(i, size)[0] for i in range(offset, offset + n)])
    return xs, (np.arange(offset, offset + n) % 4).astype(np.int32)


def to_m1(images_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1], JAX's ``x / 127.5 - 1``."""
    return images_u8.astype(np.float32) / 127.5 - 1.0


def vae_images(vae, real_u8: np.ndarray, batch: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The conv-VAE's reconstructions of ``real_u8`` and as many prior
    samples, NHWC in [-1, 1], in batches of ``batch`` on the model's device."""
    import torch

    from tinydiffusion_torch.experiments.vae_laion import reconstruct, sample_prior

    dev = next(vae.parameters()).device
    generator = torch.Generator(dev).manual_seed(seed + 1)
    recons, priors = [], []
    for i in range(0, len(real_u8), batch):
        xb = torch.from_numpy(real_u8[i:i + batch]).to(dev).permute(0, 3, 1, 2).float() / 255.0
        eps = torch.randn(len(xb), vae.latent_dim, generator=generator, device=dev)
        recons.append(reconstruct(vae, xb, eps).permute(0, 2, 3, 1).cpu().numpy())
        priors.append(sample_prior(vae, len(xb), generator).permute(0, 2, 3, 1).cpu().numpy())
    # The VAE's I/O is [0, 1] (ToTensor); featurize takes [-1, 1].
    return np.concatenate(recons) * 2.0 - 1.0, np.concatenate(priors) * 2.0 - 1.0


def read_samples(paths: list[str], size: int) -> np.ndarray:
    """PNGs as RGB, resized to size x size as Pillow does, in [-1, 1]."""
    from tinydiffusion_torch.obs.images import read_png, resize_u8, to_rgb

    return to_m1(np.stack([resize_u8(to_rgb(read_png(p)), size, size) for p in paths]))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vae-checkpoint", default="checkpoints/vae_laion_best")
    parser.add_argument("--classifier", default=None,
                        help="feature-net checkpoint (default checkpoints/fid_classifier_rgb"
                             "<size>); trained here and saved when absent")
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--latent-dim", type=int, default=128)
    parser.add_argument("--n", type=int, default=512, help="images per evaluated set")
    parser.add_argument("--n-train", type=int, default=1024, help="feature-net training images")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--samples-dir", default=None,
                        help="directory of PNGs to score against real")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json-out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

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
    from tinydiffusion_torch.io.checkpoint import weights_exist

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    size = args.image_size
    channels = rgb_channels(size)
    clf_path = args.classifier or f"checkpoints/fid_classifier_rgb{size}"

    # --- feature net: restore, or train once and save --------------------
    if weights_exist(clf_path):
        model = load_feature_net(clf_path, FeatureNet(num_classes=4, channels=channels,
                                                      in_channels=3, image_size=size))
        model = model.to(device).eval()
        print(f"loaded feature net from {clf_path}")
    elif os.path.exists(clf_path):
        parser.error(f"{clf_path} is a checkpoint without its .npz weights (a JAX Orbax "
                     "directory?); refusing to train over it")
    else:
        print(f"training RGB feature net ({args.n_train} imgs, channels {channels})...")
        x_tr, y_tr = synth_set(args.n_train, size)
        model = train_feature_net(to_m1(x_tr), y_tr, num_classes=4, channels=channels,
                                  batch_size=args.batch, seed=args.seed, device=device)
        # Accuracy on indices disjoint from the training set.
        x_te, y_te = synth_set(256, size, offset=args.n_train)
        acc = classifier_accuracy(model, to_m1(x_te), y_te, batch_size=args.batch)
        print(f"feature net accuracy: {acc:.4f}")
        save_feature_net(clf_path, model,
                         config={"feature_dim": 128, "num_classes": 4,
                                 "channels": list(channels), "image_size": size},
                         metadata={"test_accuracy": acc})

    rows: dict[str, float] = {}

    def fid_row(name: str, gen_m1: np.ndarray) -> None:
        gen_stats = frechet_gaussian_stats(featurize(model, gen_m1, batch_size=args.batch))
        rows[name] = round(fid_from_stats(*real_stats, *gen_stats), 3)
        print(f"{name}: {rows[name]}")

    # The real set and the calibration rows; the second real set's indices
    # follow the first's.
    real, _ = synth_set(args.n, size)
    real_stats = frechet_gaussian_stats(featurize(model, to_m1(real), batch_size=args.batch))
    fid_row("calibration_floor_real_vs_real", to_m1(synth_set(args.n, size, offset=args.n)[0]))
    noise = np.random.default_rng(args.seed).uniform(-1, 1, (args.n, size, size, 3))
    fid_row("calibration_ceiling_real_vs_noise", noise.astype(np.float32))

    # --- conv-VAE rows ----------------------------------------------------
    if weights_exist(args.vae_checkpoint):
        from tinydiffusion_torch.experiments.vae_laion import load_conv_vae

        vae = load_conv_vae(args.vae_checkpoint, device)
        if (vae.image_size, vae.latent_dim) != (size, args.latent_dim):
            parser.error(f"{args.vae_checkpoint} is a {vae.image_size}² VAE of latent_dim "
                         f"{vae.latent_dim}; --image-size {size} --latent-dim "
                         f"{args.latent_dim} asked")
        print(f"loaded conv-VAE from {args.vae_checkpoint}")
        recons, priors = vae_images(vae, real, args.batch, args.seed)
        fid_row("vae_recon", recons)
        fid_row("vae_prior_decode", priors)
    else:
        print(f"skip VAE rows ({args.vae_checkpoint} not found)")

    # --- a sample dump (generate_laion.py --dump-dir) ---------------------
    if args.samples_dir:
        paths = sorted(glob.glob(os.path.join(args.samples_dir, "*.png")))
        if not paths:
            sys.exit(f"no PNGs in {args.samples_dir}")
        fid_row(f"samples_dir[{len(paths)}]", read_samples(paths, size))

    result = {"image_size": size, "n": args.n, **rows}
    print(json.dumps(result))
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
