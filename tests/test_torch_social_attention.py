"""socialways_torch.kernels.social_attention: the CPU path of
``social_attention_fwd`` against the JAX fused kernel's references
(``_xla_reference`` and ``_pallas_forward`` in interpret mode), and the CUDA
kernel against its plain version on the card.

JAX is imported inside the tests that compare with it, so the CUDA tests
also run on a machine that has no JAX:
``python -m pytest tests/test_torch_social_attention.py -m cuda``."""

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.io.checkpoint import generator_params_from_jax
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import init_generator

# the kernel sums in another order than the dense form
RTOL, ATOL = 2e-4, 2e-5


def _cfg(hidden):
    return dict(hidden_size=hidden, social_feature_size=hidden,
                noise_len=hidden // 2)


def _inputs(n, hidden, seed, scene_size=7, unsorted=False):
    """Multi-agent scenes, a singleton scene and a padded tail."""
    rng = np.random.RandomState(seed)
    x4 = rng.randn(n, 4).astype(np.float32)
    h = rng.randn(n, hidden).astype(np.float32)
    ids = (np.arange(n) // scene_size).astype(np.int32)
    ids[n - 10:] = -1                    # padded tail
    ids[n - 11] = 999                    # singleton scene
    if unsorted:
        ids = ids[rng.permutation(n)]
    return x4, h, ids


def _setup(n, hidden, seed, **kw):
    """JAX feature/attention params and the port's generator holding the
    same weights (through the weight bridge), plus inputs."""
    jax = pytest.importorskip("jax")
    from socialways_tpu.config import TrainConfig as JaxConfig
    from socialways_tpu.models import init_generator as jax_init_generator
    jparams = jax_init_generator(jax.random.PRNGKey(seed),
                                 JaxConfig(**_cfg(hidden)))
    gen = init_generator(TrainConfig(**_cfg(hidden)), device="cpu")
    gen.load_state_dict(generator_params_from_jax(jax.device_get(jparams)))
    p = {"feat_mlp": jparams["feat_mlp"], "attn_w": jparams["attn_w"]}
    return (p, gen) + _inputs(n, hidden, seed, **kw)


def _jax_reference(p, x4, h, ids, pallas_interpret=False):
    jnp = pytest.importorskip("jax.numpy")
    from socialways_tpu.kernels.social_attention import (_pallas_forward,
                                                         _xla_reference)
    args = (p, jnp.asarray(x4), jnp.asarray(h), jnp.asarray(ids))
    if pallas_interpret:
        return np.asarray(_pallas_forward(*args, interpret=True))
    return np.asarray(_xla_reference(*args))


def _port(gen, x4, h, ids, device="cpu"):
    with torch.no_grad():
        return sa.social_attention_fwd(
            gen.feat_mlp, gen.attn_w, torch.from_numpy(x4).to(device),
            torch.from_numpy(h).to(device), torch.from_numpy(ids).to(device))


@pytest.mark.parametrize("hidden", [16, 32])
def test_torch_social_attention_cpu_matches_xla_reference(hidden):
    p, gen, x4, h, ids = _setup(96, hidden, seed=hidden)
    before = sa.social_attention_fwd.launches
    got = _port(gen, x4, h, ids).numpy()
    want = _jax_reference(p, x4, h, ids)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[-11:], 0.0)   # singleton + padding
    assert sa.social_attention_fwd.launches == before   # CPU: plain path


def test_torch_social_attention_cpu_matches_pallas_interpret():
    p, gen, x4, h, ids = _setup(100, 32, seed=5)
    got = _port(gen, x4, h, ids).numpy()
    want = _jax_reference(p, x4, h, ids, pallas_interpret=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torch_social_attention_unsorted_ids_match_xla_reference():
    """The port assumes no order of the scene ids (the TPU kernel needs them
    sorted); the dense JAX reference is order-free too."""
    p, gen, x4, h, ids = _setup(64, 16, seed=9, unsorted=True)
    got = _port(gen, x4, h, ids).numpy()
    want = _jax_reference(p, x4, h, ids)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("n,hidden,scene,unsorted", [
    (256, 64, 7, False), (256, 32, 7, False), (300, 64, 13, True),
    (2048, 64, 64, False)])
def test_torch_social_attention_kernel_matches_plain_on_cuda(
        n, hidden, scene, unsorted):
    _need_cuda()
    gen = init_generator(TrainConfig(**_cfg(hidden)),
                         torch.Generator().manual_seed(n), "cuda")
    x4, h, ids = _inputs(n, hidden, seed=n, scene_size=scene,
                         unsorted=unsorted)
    before = sa.social_attention_fwd.launches
    got = _port(gen, x4, h, ids, "cuda")
    torch.cuda.synchronize()
    assert sa.social_attention_fwd.launches == before + 1
    with torch.no_grad():
        want = sa.social_attention_plain(
            gen.feat_mlp, gen.attn_w, torch.from_numpy(x4).cuda(),
            torch.from_numpy(h).cuda(), torch.from_numpy(ids).cuda())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_torch_social_attention_kernel_refuses_bad_inputs_on_cuda():
    _need_cuda()
    gen = init_generator(TrainConfig(**_cfg(32)),
                         torch.Generator().manual_seed(1), "cuda")
    x4, h, ids = _inputs(64, 32, seed=1)
    x4c, hc = torch.from_numpy(x4).cuda(), torch.from_numpy(h).cuda()
    idc = torch.from_numpy(ids).cuda()
    with torch.no_grad():
        with pytest.raises(ValueError, match="scene_ids"):
            sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, x4c, hc,
                                    idc.long())
        with pytest.raises(ValueError, match="contiguous"):
            sa.social_attention_fwd(gen.feat_mlp, gen.attn_w,
                                    x4c.t().contiguous().t(), hc, idc)
    with pytest.raises(ValueError, match="scene_ids"):   # grad mode too
        sa.social_attention_fwd(gen.feat_mlp, gen.attn_w, x4c, hc,
                                idc.long())
