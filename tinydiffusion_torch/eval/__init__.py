"""Sample-quality evaluation (FID); see the JAX counterpart ``tinydiffusion_tpu.eval``."""

from tinydiffusion_torch.eval.fid import (  # noqa: F401
    FeatureNet,
    fid_from_stats,
    frechet_gaussian_stats,
    featurize,
    train_feature_net,
)
