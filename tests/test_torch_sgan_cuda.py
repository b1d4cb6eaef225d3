"""Social GAN's pool kernel on the card (kernels/social_pool.py,
csrc/social_pool.cuh): ``cuda`` mark, skipped without a CUDA device; no
JAX (``python -m pytest tests/test_torch_sgan_cuda.py -m cuda
--noconftest -s``).

- The kernel against the plain scene-window form
  (``ops/sgan_pool.social_pool_windowed``, on the card, on the same
  seeded weights and inputs) at N = 256 and 10,000 in sorted scenes of
  1-64 agents with padded rows, bf16 and float32: every output within
  the tolerances below, the mean gap within ``MEAN_GAP``; the scene
  window w = 64 and the full scan w = 0 give equal bits; a launch
  counted once.
- The diagonal flag added to ``warp_fill`` leaves the attention kernels
  as they were: each narrow attention entry file compiled with nvcc
  ``-Xptxas -v`` against the header as it is and against the header with
  the flag taken out gives the same registers, shared memory and spills
  for every kernel.
"""

import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from socialways_torch.config import TrainConfig
from socialways_torch.kernels import _build
from socialways_torch.kernels import social_pool as spk
from socialways_torch.models.sgan import init_sgan
from socialways_torch.ops.nn import cast_params
from socialways_torch.ops.sgan_pool import social_pool_windowed

#: the gaps allowed between the kernel and the plain form.  bf16: the
#: float sums run in another order (and inside the tensor cores' mma), so
#: a relu of layer 1 rounds to its other bf16 neighbour now and then, and
#: the pair it belongs to moves by about a bf16 ulp of z times |W_2| (a few
#: 1e-4 at |P| ~ 0.4); float32: the order of the float sums alone
ATOL = {torch.bfloat16: 2e-3, torch.float32: 2e-5}
#: the mean gap allowed: flips are rare, so the mean stays far below a
#: single flip's size (a kernel off the rounding points, e.g. layer 1 not
#: rounded to bf16 before layer 2, moves every output)
MEAN_GAP = {torch.bfloat16: 2e-5, torch.float32: 1e-6}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _crowd(n: int, seed: int):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 65, size=n)
    ids = np.repeat(np.arange(n), sizes)[:n].astype(np.int32)
    ids[-7:] = -1
    pos = rng.random((n, 2), dtype=np.float32)
    h = rng.standard_normal((n, 32), dtype=np.float32) * 0.3
    return torch.from_numpy(pos), torch.from_numpy(h), torch.from_numpy(ids)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [256, 10_000])
def test_torch_sgan_pool_kernel_matches_windowed_cuda(n, dtype):
    dev = _card()
    cfg = TrainConfig(model="sgan", noise_len=8, noise_dist="gaussian",
                      max_scene_size=64)
    gen = cast_params(init_sgan(cfg, torch.Generator().manual_seed(n), dev),
                      dtype)
    pos, h, ids = (t.to(dev) for t in _crowd(n, n + 1))
    pos, h = pos.to(dtype), h.to(dtype)
    with torch.no_grad():
        want = social_pool_windowed(gen.pool_embed, gen.pool_mlp, pos, h,
                                    ids, 64)
        before = spk.social_pool_fused.launches_bf16 + \
            spk.social_pool_fused.launches
        got = spk.social_pool_fused(gen.pool_embed, gen.pool_mlp, pos, h,
                                    ids, 64)
        torch.cuda.synchronize()
        assert (spk.social_pool_fused.launches_bf16
                + spk.social_pool_fused.launches) == before + 1
        full = spk.social_pool_fused(gen.pool_embed, gen.pool_mlp, pos, h,
                                     ids, 0)
    gap = (got - want).abs()
    print(f"\nN={n} {dtype}: largest gap {gap.max().item():.3e}, mean "
          f"{gap.mean().item():.3e}, |P| up to {want.abs().max().item():.3f} "
          f"[{torch.cuda.get_device_name()}]")
    assert torch.equal(got, full)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[ids < 0], torch.zeros_like(got[ids < 0]))
    assert gap.max().item() <= ATOL[dtype]
    assert gap.mean().item() <= MEAN_GAP[dtype]


def _ptxas_entries(log: str) -> dict:
    """{mangled kernel: its ptxas 'Used' and spill lines} of nvcc's
    ``-Xptxas -v`` output."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            # an anonymous namespace's mangled name holds a hash of the
            # file's path, which differs between the two trees
            cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "(anon)",
                         m.group(1))
        elif cur and ("Used" in line or "spill" in line):
            entries.setdefault(cur, []).append(
                re.sub(r"^.*?:\s*", "", line.strip()))
    return entries


@pytest.mark.cuda
def test_torch_sgan_diagonal_flag_keeps_attention_ptxas_cuda():
    _card()
    names = ["social_attention_fwd", "social_attention_fwd_bf16",
             "social_attention_bwd", "social_attention_bwd_bf16"]
    with tempfile.TemporaryDirectory() as tmp:
        old = os.path.join(tmp, "old")
        shutil.copytree(_build.CSRC, old)
        path = os.path.join(old, "social_attention_pairs.cuh")
        with open(path) as f:
            text = f.read()
        stripped = text.replace("template <bool kSelf = false>\n", "")
        stripped = stripped.replace("(kSelf || o != self)", "o != self")
        assert "template <bool kSelf" not in stripped
        assert "(kSelf ||" not in stripped
        with open(path, "w") as f:
            f.write(stripped)
        procs = {}
        for tree in (_build.CSRC, old):
            for name in names:
                out = os.path.join(tmp, f"{name}-{len(procs)}.so")
                procs[(tree, name)] = subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                     os.path.join(tree, name + ".cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
        logs = {}
        for key, proc in procs.items():
            logs[key] = proc.communicate()[0]
            assert proc.returncode == 0, logs[key]
    for name in names:
        now = _ptxas_entries(logs[(_build.CSRC, name)])
        before = _ptxas_entries(logs[(old, name)])
        print(f"\n{name}: {sorted(set(map(tuple, now.values())))}")
        assert now and now == before, name
