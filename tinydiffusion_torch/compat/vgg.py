"""VGG16 ``features[:16]`` weights for the conv-VAE's perceptual loss.

Counterpart of ``tinydiffusion_tpu/compat/vgg.py``. The reference's
perceptual loss runs images through a frozen pretrained torchvision VGG16
prefix (``vgg16(weights=DEFAULT).features[:16]``) with no ImageNet
normalisation, and ``models.vae_conv.PerceptualNet`` has that prefix's
structure: 3x3 convs at torchvision indices 0, 2 | 5, 7 | 10, 12, 14, a
ReLU after each, max-pools at 4 and 9. This module maps a torchvision
``vgg16`` state dict (``features.N.*`` keys, ``classifier.*`` ignored) or a
bare ``features`` one (``N.*`` keys) onto ``PerceptualNet``'s state dict.
Both are OIHW, so nothing is transposed. torchvision is not imported: the
file is read with ``torch.load``.
"""

from __future__ import annotations

from typing import Mapping

import torch

# torchvision vgg16: index in features[:16] -> (PerceptualNet name, in, out).
VGG16_FEATURES16_CONV_LAYOUT = {
    0: ("conv0_0", 3, 64),
    2: ("conv0_1", 64, 64),
    5: ("conv1_0", 64, 128),
    7: ("conv1_1", 128, 128),
    10: ("conv2_0", 128, 256),
    12: ("conv2_1", 256, 256),
    14: ("conv2_2", 256, 256),
}


def convert_vgg16_features(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict -> ``PerceptualNet``'s state dict
    (float32 on the CPU). Raises ``KeyError`` on a missing conv and
    ``ValueError`` on a mis-shaped one."""
    sd = dict(state_dict)

    def get(idx: int, leaf: str) -> torch.Tensor:
        for key in (f"features.{idx}.{leaf}", f"{idx}.{leaf}"):
            if key in sd:
                return sd[key].detach().to("cpu", torch.float32)
        raise KeyError(f"the VGG16 state dict has no features[{idx}].{leaf}")

    out: dict[str, torch.Tensor] = {}
    for idx, (name, c_in, c_out) in VGG16_FEATURES16_CONV_LAYOUT.items():
        weight, bias = get(idx, "weight"), get(idx, "bias")
        if tuple(weight.shape) != (c_out, c_in, 3, 3) or tuple(bias.shape) != (c_out,):
            raise ValueError(
                f"features[{idx}] ({name}): weight {tuple(weight.shape)}, bias "
                f"{tuple(bias.shape)}; want {(c_out, c_in, 3, 3)} and {(c_out,)}")
        out[f"{name}.weight"] = weight.contiguous()
        out[f"{name}.bias"] = bias.contiguous()
    return out


def load_vgg16_perceptual(path: str) -> dict[str, torch.Tensor]:
    """``convert_vgg16_features`` of the file ``torch.save(vgg16(...).state_dict(),
    path)`` (or of its ``features`` prefix) wrote."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return convert_vgg16_features(obj)
