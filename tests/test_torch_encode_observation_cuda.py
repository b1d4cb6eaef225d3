"""The bf16 observation encoder as one kernel (kernels/encode_observation.py,
csrc/encode_observation_bf16.cu) and the dispatch that sends an encode to
it (models/generator.py ``fused_encode``).

On the CPU (every run): the plain path is kept, and ``encode.fused`` does
not gain, for an encode on the CPU, in float32, under autograd with and
without ``remat`` and under an ensemble's member ``vmap``, with the card
check faked true for all but the CPU case (a bf16 encode under no_grad
then reaches a fake kernel, the control, and counts once); a bf16 encode
"on the card" at hidden 80 reaches the kernel's wrapper and raises, naming
its widths, with neither the plain path nor a launch run and nothing
counted; the wrapper raises on each width, dtype and layout the kernel
does not take, before any launch; and chip_smoke.py reads the encoder's
ptxas lines (registers and spills of each padded width).

On the card (``cuda`` mark, skipped without one; no JAX: ``python -m
pytest tests/test_torch_encode_observation_cuda.py -m cuda --noconftest
-s``): the fused encoder against the plain bf16 path (the embedding and
``lstm_seq``) on the same seeded weights and observations, at N = 1, 15,
64, 1,000 and 65,537 rows of T = 8 steps, at T = 1 and 20, and at hidden
16, 24, 40 and 48; h and c within ``ATOL`` + ``RTOL`` |plain| (the sums
run in another order, so a bf16 rounding of e, h or c flips now and then
and the later steps carry it on) and the mean gap within ``MEAN_GAP``;
two launches with equal bits; a launch captured in a CUDA graph and
replayed equal to an eager one; and a launch into memory filled with NaN
first giving the same finite bits.  The plain bf16 path itself is held to
JAX's on the CPU (tests/test_torch_bf16.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (numpy only at import)
import socialways_torch.models.generator as gen_mod  # noqa: E402
from socialways_torch.config import TrainConfig  # noqa: E402
from socialways_torch.kernels import encode_observation as eo  # noqa: E402
from socialways_torch.kernels import social_attention as sa  # noqa: E402
from socialways_torch.models.generator import (  # noqa: E402
    encode_observation, init_generator)
from socialways_torch.models.stacked import Members, stack_modules  # noqa: E402
from socialways_torch.ops.nn import cast_params  # noqa: E402
from socialways_torch.ops.traj import obsv_to_4d  # noqa: E402
from socialways_torch.utils import profiling  # noqa: E402

BF = torch.bfloat16
#: the gap allowed between the fused encoder and the plain path, in h and
#: c: the largest read on an H100 was 0.0039 in h (1,048,576 rows, |h| <
#: 0.6) and 0.0078 in c (65,537 rows, |c| up to 1.57), one bf16 ulp of the
#: value carried on; 0 at N = 1 and 64
ATOL, RTOL = 0.02, 0.02
#: the mean gap allowed, h and c each: the largest read on an H100 over
#: every case below was 7.06e-7 (c at N = 1,000, T = 20; h 2.95e-7).
#: Mutants of the kernel read more: tanh.approx gates 2.71e-6 (h) to
#: 1.26e-5 (c), c kept in float32 across steps 9.2e-5 (h) and 2.2e-4 (c),
#: the embedding's bias joined after rounding 2.0e-4 (h) and 4.4e-4 (c);
#: __expf and __fdividef in the sigmoid read as the kernel does (1.9e-7,
#: 2.3e-7 in c), below what a plain-path comparison resolves
MEAN_GAP = 1.5e-6


def _model(hidden: int, seed: int = 0, device="cpu"):
    cfg = TrainConfig(hidden_size=hidden, social_feature_size=hidden,
                      noise_len=max(hidden // 2, 1))
    g = init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    return g.to(device).requires_grad_(device == "cpu")


def _obsv(n: int, steps: int, dtype, seed: int, device="cpu"):
    """obsv_4d [n, steps, 4] of random walks in a canonical frame, as
    ``prepare_rollout`` makes it from positions of ``dtype``; one step is
    the last of two (a strided view)."""
    rng = np.random.RandomState(seed)
    walk = np.cumsum(rng.randn(n, max(steps, 2), 2) * 0.1, axis=1)
    p = rng.rand(n, 1, 2) * 4 - 2 + walk - walk[:, -1:]
    return obsv_to_4d(torch.from_numpy(p.astype(np.float32)).to(
        device, dtype))[:, -steps:]


# --------------------------------------------------------------- the CPU
def _fake_kernel(calls):
    def kernel(params, obsv_4d):
        calls.append(obsv_4d.shape[0])
        n, hid = obsv_4d.shape[0], params.embed.w.shape[1]
        return (torch.zeros(n, hid, dtype=obsv_4d.dtype),) * 2
    return kernel


def _run_case(case: str):
    """An encode of ``case`` on the CPU: its h."""
    dtype = torch.float32 if case == "float32" else BF
    g = _model(16)
    params = cast_params(g, dtype)
    x = _obsv(5, 8, dtype, 1)
    if case in ("grad", "remat"):
        with torch.enable_grad():
            h = encode_observation(params, x, remat=case == "remat")[0]
        assert h.requires_grad
        return h
    with torch.no_grad():
        if case == "vmap":
            stacked = stack_modules([g, _model(16, seed=1)]).to(BF)
            return Members(2)(lambda gm, xm: encode_observation(gm, xm)[0],
                              (stacked,), torch.stack([x, x]))
        return encode_observation(params, x)[0]


@pytest.mark.parametrize("case", ["cpu", "float32", "grad", "remat", "vmap",
                                  "bf16 no_grad"])
def test_torch_encode_dispatch_keeps_the_plain_path(case, monkeypatch):
    """Each case but the last takes the plain path (a real output, no
    kernel call, ``encode.fused`` unchanged); the last, the control,
    reaches the kernel once and counts it."""
    calls = []
    monkeypatch.setattr(gen_mod, "encode_observation_bf16",
                        _fake_kernel(calls))
    if case != "cpu":
        monkeypatch.setattr(gen_mod, "_on_card", lambda t: True)
    before = profiling.counters.get("encode.fused", 0)
    h = _run_case(case)
    gained = profiling.counters.get("encode.fused", 0) - before
    if case == "bf16 no_grad":
        assert calls == [5] and gained == 1
        return
    assert calls == [] and gained == 0
    assert bool(h.isfinite().all()) and bool((h != 0).any())


def test_torch_encode_on_the_card_past_hidden_64_raises(monkeypatch):
    """A bf16 no-grad encode at hidden 80 with the card check faked true
    takes no plain path on the card: the kernel's wrapper refuses it,
    naming its widths, before any launch, and nothing is counted."""
    plain = []
    monkeypatch.setattr(gen_mod, "_on_card", lambda t: True)
    monkeypatch.setattr(gen_mod, "lstm_seq",
                        lambda *a, **k: plain.append(1))
    params = cast_params(_model(80), BF)
    x = _obsv(5, 8, BF, 1)
    before = profiling.counters.get("encode.fused", 0)
    launches = eo.encode_observation_bf16.launches
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="hidden widths up to 64"):
        encode_observation(params, x)
    assert plain == [] and eo.encode_observation_bf16.launches == launches
    assert profiling.counters.get("encode.fused", 0) == before


def _malformed(what: str):
    """Hidden-64 bf16 operands on the CPU with one fault ``what``."""
    params = cast_params(_model(64), BF)
    x = _obsv(6, 8, BF, 3)
    if what == "hidden past 64":
        params = cast_params(_model(80), BF)
    elif what == "not [N, T, 4]":
        x = x[..., :3]
    elif what == "obsv dtype":
        x = x.float()
    elif what == "odd step stride":
        x = torch.cat([x, x[..., :1]], -1)[..., :4]
    elif what == "columns":
        x = torch.cat([x, x], -1)[..., ::2]
    elif what == "alignment":
        x = torch.cat([torch.zeros(1, dtype=BF), x.flatten()])[1:].view(
            x.shape)
    elif what == "weight shape":
        params.encoder.w = params.encoder.w[:, :128]
    elif what == "weight dtype":
        params.embed.b = params.embed.b.float()
    elif what == "weight contiguity":
        params.encoder.w = params.encoder.w.t().contiguous().t()
    return params, x


@pytest.mark.parametrize("what,match", [
    ("hidden past 64", "hidden widths up to 64"),
    ("not [N, T, 4]", r"must be \[N, T, 4\]"),
    ("obsv dtype", "obsv_4d has dtype"),
    ("odd step stride", "even strides in the other dimensions"),
    ("columns", "unit columns"), ("alignment", "4-byte aligned"),
    ("weight shape", "encoder.w has shape"),
    ("weight dtype", "embed.b has dtype"),
    ("weight contiguity", "encoder.w must be contiguous"),
    ("nothing", "runs on CUDA")])
def test_torch_fused_encode_wrapper_refuses_what_the_kernel_cannot_take(
        what, match):
    """Each fault raises before any launch; well-formed operands on the
    CPU raise only for the device."""
    params, x = _malformed(what)
    launches = eo.encode_observation_bf16.launches
    with pytest.raises(ValueError, match=match):
        eo.encode_observation_bf16(params, x)
    assert eo.encode_observation_bf16.launches == launches


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN6encode25encode_observation_kernelILi4EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN6encode25encode_observation_kernelILi4EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN6encode25encode_observation_kernelILi2EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN6encode25encode_observation_kernelILi2EEEvNS_4ArgsE
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 86 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN6decode21decode_rollout_kernelILi4ELi2ELb1EEEvNS_4ArgsE' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_torch_chip_smoke_reads_the_encoders_ptxas():
    """chip_smoke.py's phase-2 readers of the fused kernels' builds:
    registers and spills of each of the encoder's padded widths (a spill
    fails the build check), and of the decode's instantiations beside
    them in one log."""
    assert cs.encode_ptxas(_PTXAS) == {4: (127, 0, 0), 2: (86, 4, 12)}
    assert cs.decode_ptxas(_PTXAS) == {(4, 2, True): (168, 0, 0)}


# -------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(n: int, steps: int, seed: int, hidden: int = 64):
    dev = _card()
    g = _model(hidden, seed=seed, device=dev)
    return cast_params(g, BF), _obsv(n, steps, BF, seed + 1, dev)


def _fused(params, x):
    with torch.no_grad():
        return encode_observation(params, x)


def _hold(params, x, what: str) -> None:
    """The fused encoder within the bounds of the plain path on the same
    operands (grad on, nothing requiring it), one launch."""
    launches = eo.encode_observation_bf16.launches
    fused = _fused(params, x)
    assert eo.encode_observation_bf16.launches == launches + 1
    with torch.enable_grad():
        plain = encode_observation(params, x)
    assert eo.encode_observation_bf16.launches == launches + 1
    hid = params.embed.w.shape[1]
    for name, f, p in zip("hc", fused, plain):
        assert f.dtype == p.dtype == BF
        assert f.shape == p.shape == (x.shape[0], hid)
        f, p = f.float(), p.float()
        gap = (f - p).abs()
        print(f"{what} {name}: largest gap {gap.max().item():.4g}, mean gap "
              f"{gap.mean().item():.4g}, largest |plain| "
              f"{p.abs().max().item():.4g}, elements off: "
              f"{(gap > 0).float().mean():.4g} "
              f"[{torch.cuda.get_device_name()}]")
        assert bool((gap <= ATOL + RTOL * p.abs()).all())
        assert gap.mean().item() <= MEAN_GAP


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 64, 1000, 65_537])
def test_torch_fused_encode_matches_the_plain_path_cuda(n):
    _hold(*_card_case(n, 8, 7 + n), f"n={n} T=8")


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 20])
def test_torch_fused_encode_matches_the_plain_path_at_other_steps_cuda(
        steps):
    _hold(*_card_case(1000, steps, 50 + steps), f"n=1000 T={steps}")


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [16, 24, 40, 48])
def test_torch_fused_encode_matches_the_plain_path_at_other_widths_cuda(
        hidden):
    """Each padded width of the library (16, 32 through 24, 48) and widths
    that pad unevenly."""
    _hold(*_card_case(1000, 8, hidden, hidden), f"n=1000 hidden={hidden}")


@pytest.mark.cuda
def test_torch_fused_encode_repeats_its_bits_cuda():
    params, x = _card_case(1000, 8, 3)
    a, b = _fused(params, x), _fused(params, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_torch_fused_encode_replays_in_a_graph_cuda():
    """Captured in a CUDA graph, the launch replays the eager bits, on the
    inputs as captured and after they change in place; the capture counts
    nothing and records one launch."""
    params, x = _card_case(4096, 8, 5)
    eager = _fused(params, x)
    graph = torch.cuda.CUDAGraph()
    before = sa.launch_counts()
    with sa.captured_launches() as record:
        with torch.cuda.graph(graph):
            out = _fused(params, x)
    assert sa.launch_counts() == before
    assert record == {(eo.encode_observation_bf16, "launches"): 1}
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))
    x.mul_(0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, _fused(params, x)))


@pytest.mark.cuda
def test_torch_fused_encode_reads_no_stale_memory_cuda():
    """h and c come from memory filled with NaN first: every element is
    written, and the bits are those of a clean launch."""
    params, x = _card_case(65_537, 8, 11)
    res = []
    for _ in range(2):
        junk = torch.full((1 << 26,), float("nan"), device="cuda")
        del junk
        res.append(_fused(params, x))
        torch.cuda.synchronize()
    assert all(bool(t.isfinite().all()) for t in res[0])
    assert all(torch.equal(a, b) for a, b in zip(*res))
