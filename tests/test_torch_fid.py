"""The port's FID stack (``tinydiffusion_torch/eval/fid.py``) against the JAX package, on the CPU.

``FeatureNet`` on both committed classifiers (``checkpoints/fid_classifier``
on synthetic MNIST test images, ``fid_classifier_rgb256`` on synthesized
LAION images) against flax; the Gaussian statistics and the Frechet
distance against JAX's on the same features; ``fid_score`` against JAX's;
one ``train_feature_net`` Adam step against an optax step from the same
params and batch; ``train_feature_net`` learning the synthetic digits;
``load_mnist`` equal to JAX's, value for value.
"""

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinydiffusion_tpu.data.mnist import load_mnist as jax_load_mnist
from tinydiffusion_tpu.eval import fid as jax_fid
from tinydiffusion_tpu.io.checkpoint import restore_checkpoint
from tinydiffusion_torch.data.mnist import load_mnist
from tinydiffusion_torch.eval import fid
from tinydiffusion_torch.io.from_jax import feature_net_from_jax
from tinydiffusion_torch.tools.fid_eval_laion import rgb_channels, synth_set, to_m1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_CLASSIFIER = os.path.join(REPO, "checkpoints", "fid_classifier")
RGB_CLASSIFIER = os.path.join(REPO, "checkpoints", "fid_classifier_rgb256")
# float32 features and logits: the two frameworks sum the convolutions and
# the 3136- / 8192-term fc1 products in different orders; read ~6e-7 of the
# largest feature.
FEATURE_RTOL = 1e-5
# FIDs from features that differ by that much (float64 statistics): ~1e-6
# relative.
FID_RTOL = 1e-4
# One Adam step in float32 from the same params and batch.
STEP_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mnist_test(tmp_path_factory):
    """The synthetic MNIST test set (10 000 images) and a 1024-image train set."""
    root = str(tmp_path_factory.mktemp("mnist"))
    x_test, y_test = load_mnist(root, train=False)
    x_train, y_train = load_mnist(root, train=True, synthetic_n=1024)
    return root, x_test, y_test, x_train, y_train


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _jax_net(path: str, model, image_size: int, in_channels: int):
    template = jax.device_get(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, image_size, image_size, in_channels))))
    return restore_checkpoint(path, template["params"])


def test_load_mnist_equals_jax(mnist_test):
    root, x_test, y_test, x_train, _ = mnist_test
    for train, (x, n) in ((False, (x_test, None)), (True, (x_train, 1024))):
        want, labels = jax_load_mnist(root, train=train, synthetic_n=n)
        np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(y_test, jax_load_mnist(root, train=False)[1])
    assert x_test.min() == -1.0 and x_test.max() == 1.0


@pytest.mark.parametrize("which", ["mnist", "rgb256"])
def test_feature_net_matches_flax(which, mnist_test):
    if which == "mnist":
        images = mnist_test[1][:256]
        port = fid.FeatureNet()
        jmodel, path = jax_fid.FeatureNet(), MNIST_CLASSIFIER
    else:
        images = to_m1(synth_set(8, 256)[0])
        port = fid.FeatureNet(num_classes=4, channels=rgb_channels(256), in_channels=3,
                              image_size=256)
        jmodel = jax_fid.FeatureNet(num_classes=4, channels=rgb_channels(256))
        path = RGB_CLASSIFIER
    fid.load_feature_net(path, port).eval()
    params = _jax_net(path, jmodel, images.shape[1], images.shape[-1])
    want_logits, want_feats = jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, return_features=True))(params, jnp.asarray(images))
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(images).permute(0, 3, 1, 2), return_features=True)
    _close(feats.numpy(), want_feats, FEATURE_RTOL)
    _close(logits.numpy(), want_logits, FEATURE_RTOL)
    # featurize: the tail batch run as it is gives the rows of one whole batch.
    np.testing.assert_allclose(fid.featurize(port, images[:7], batch_size=3),
                               fid.featurize(port, images[:7]), rtol=0, atol=1e-5)
    got = fid.featurize(port, images, batch_size=5)
    _close(got, jax_fid.featurize(jmodel, params, images, batch_size=5), FEATURE_RTOL)
    labels = np.arange(len(images)) % port.num_classes
    assert fid.classifier_accuracy(port, images, labels, batch_size=5) == pytest.approx(
        jax_fid.classifier_accuracy(jmodel, params, images, labels, batch_size=5))


def test_frechet_math_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((300, 16)), 0.5 + 1.3 * rng.standard_normal((200, 16))
    for got, want in zip(fid.frechet_gaussian_stats(a), jax_fid.frechet_gaussian_stats(a)):
        np.testing.assert_array_equal(got, want)
    stats = fid.frechet_gaussian_stats(a) + fid.frechet_gaussian_stats(b)
    assert fid.fid_from_stats(*stats) == jax_fid.fid_from_stats(*stats)
    assert fid.fid_from_stats(*stats[:2], *stats[:2]) == pytest.approx(0.0, abs=1e-8)
    with pytest.raises(ValueError):
        fid.frechet_gaussian_stats(np.zeros((1, 5)))


def test_fid_score_matches_jax(mnist_test):
    x_test = mnist_test[1]
    port = fid.load_feature_net(MNIST_CLASSIFIER, fid.FeatureNet()).eval()
    jmodel = jax_fid.FeatureNet()
    params = _jax_net(MNIST_CLASSIFIER, jmodel, 28, 1)
    noise = np.random.default_rng(3).standard_normal((256, 28, 28, 1)).astype(np.float32)
    for gen in (x_test[256:512], noise):
        got = fid.fid_score(port, x_test[:256], gen)
        want = jax_fid.fid_score(jmodel, params, x_test[:256], gen)
        assert got == pytest.approx(want, rel=FID_RTOL)
    assert fid.fid_score(port, x_test[:256], x_test[256:512]) < 0.1 * fid.fid_score(
        port, x_test[:256], noise)


def test_feature_net_adam_step_matches_optax(mnist_test):
    _, x_test, y_test, _, _ = mnist_test
    xb, yb = x_test[:16], y_test[:16]
    jmodel = jax_fid.FeatureNet(feature_dim=32, channels=(8, 16))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 1)))["params"]
    flat = {f"{k[0].key}/{k[1].key}": np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(params)}
    port = fid.FeatureNet(feature_dim=32, channels=(8, 16))
    port.load_state_dict(feature_net_from_jax(flat))
    optimizer = torch.optim.Adam(port.parameters(), lr=1e-3)
    loss = fid.feature_net_step(port, optimizer, torch.from_numpy(xb).permute(0, 3, 1, 2),
                                torch.from_numpy(yb).long())

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(xb))
        return optax.softmax_cross_entropy_with_integer_labels(logits, yb).mean()

    tx = optax.adam(1e-3)

    @jax.jit
    def step(p):
        value, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return value, optax.apply_updates(p, updates)

    want_loss, new = step(params)
    new_flat = {f"{k[0].key}/{k[1].key}": np.asarray(v)
                for k, v in jax.tree_util.tree_leaves_with_path(new)}
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    for name, value in feature_net_from_jax(new_flat).items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), value.numpy(), rtol=0,
                                   atol=STEP_ATOL, err_msg=name)


def test_init_is_flax_lecun_normal():
    model = fid.init_flax_(fid.FeatureNet(), torch.Generator().manual_seed(0))
    for name, fan_in in (("conv2", 9 * 32), ("fc1", 3136)):
        w = getattr(model, name).weight.detach()
        assert w.abs().max() <= 2 * np.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-7
        assert w.std().item() == pytest.approx(np.sqrt(1 / fan_in), rel=0.05)
        assert not getattr(model, name).bias.any()


def test_train_feature_net_learns_synthetic_digits(mnist_test, tmp_path):
    _, x_test, y_test, x_train, y_train = mnist_test
    model = fid.train_feature_net(x_train, y_train, epochs=3, batch_size=64, seed=0,
                                  device="cpu")
    acc = fid.classifier_accuracy(model, x_test[:512], y_test[:512])
    assert acc >= 0.9, acc
    again = fid.train_feature_net(x_train, y_train, epochs=3, batch_size=64, seed=0,
                                  device="cpu")
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name  # the seed fixes the init and the order
    # Saved in JAX's layout and read back, by the port and by JAX.
    path = str(tmp_path / "clf")
    fid.save_feature_net(path, model, {"feature_dim": 128}, {"test_accuracy": acc})
    back = fid.load_feature_net(path, fid.FeatureNet()).eval()
    jmodel = jax_fid.FeatureNet()
    params = _jax_net(path, jmodel, 28, 1)
    _close(fid.featurize(back, x_test[:64]), jax_fid.featurize(jmodel, params, x_test[:64]),
           FEATURE_RTOL)
