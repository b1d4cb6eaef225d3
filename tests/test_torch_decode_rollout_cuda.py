"""The bf16 FC decode as one kernel (kernels/decode_rollout.py,
csrc/decode_rollout_bf16.cu) and the dispatch that sends a rollout to it
(models/generator.py ``fused_decode``).

On the CPU (every run): the plain loop is kept, and ``decode.fused`` does
not gain, for a rollout on the CPU, in float32, with the LSTM decoder,
under autograd and under an ensemble's member ``vmap``, with the card
check faked true for all but the CPU case (a bf16 FC rollout under no_grad
then reaches a fake kernel, the control); R draws of N prepared rows reach
the kernel as N rows and the plain loop as R copies (``prep_for_draws``
gives the same); and the wrapper
raises on each width, dtype and layout the kernel does not take, before
any launch.

On the card (``cuda`` mark, skipped without one; no JAX: ``python -m
pytest tests/test_torch_decode_rollout_cuda.py -m cuda --noconftest``):
the fused decode against the plain bf16 loop on the same seeded weights
and inputs, at N = 1, 15, 64, 1,000 and 65,537 prepared rows and R = 1
and 20 draws a row at the crowd widths, and at N = 1,000, R = 20 at other
widths (each padded shape of the library, an odd one); every output
within ``ATOL`` + ``RTOL`` |plain| (the sums run in another order, so a
bf16 rounding of a layer's output flips now and then and the
autoregressive steps carry it on) and the mean gap within ``MEAN_GAP``
(which a kernel off the plain loop's rounding points or gate math
passes); two launches with equal bits; a launch captured in a CUDA graph
and replayed equal to an eager one, counted once a replay; and a launch
into memory filled with NaN first giving the same finite bits.  The plain
bf16 loop itself is held to JAX's bf16 rollout on the CPU
(tests/test_torch_bf16.py).
"""

import pytest
import torch

import socialways_torch.models.generator as gen_mod
from socialways_torch.config import TrainConfig
from socialways_torch.kernels import decode_rollout as dr
from socialways_torch.kernels import social_attention as sa
from socialways_torch.models.generator import (decode_rollout, init_generator,
                                               prep_for_draws)
from socialways_torch.models.stacked import Members, stack_modules
from socialways_torch.ops.nn import cast_params
from socialways_torch.utils import profiling

BF = torch.bfloat16
#: the gap allowed between the fused decode and the plain loop: the
#: largest read on an H100 at the crowd widths was 0.0469 (N = 65,537,
#: R = 20, |plain| up to 4.59), a few bf16 ulps of a position, and 0 at
#: N <= 15, R = 1; 0.0625 at widths (21, 13, 7) (|plain| up to 6.75)
ATOL, RTOL = 0.05, 0.02
#: the mean gap allowed: the largest read on an H100 over every case
#: below was 3.27e-6 (widths (64, 64, 64); 3.20e-6 at N = 1,000, R = 20
#: at the crowd widths).  Mutants of the kernel read 2.09e-5 and more
#: with tanh.approx gates, 2.1e-4 with a float 0.2 slope, 3.8e-4 with the
#: bias joined after rounding; __expf gates and an fma in the cell update
#: read as the kernel does (2.3e-6), below what a plain-loop comparison
#: resolves
MEAN_GAP = 1e-5


#: the crowd models' widths: hidden, social context, noise
CROWD = (64, 64, 32)


def _model(hidden: int, noise_len: int, decoder: str = "fc",
           seed: int = 0, device="cpu", social: int = 0):
    cfg = TrainConfig(hidden_size=hidden,
                      social_feature_size=social or hidden,
                      noise_len=noise_len, decoder=decoder)
    g = init_generator(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, g.to(device).requires_grad_(device == "cpu")


def _prep(n: int, r: int, hidden: int, noise_len: int, dtype, seed: int,
          device="cpu", social: int = 0):
    """(h, c, s, last_p) of n rows and noise of r n rows; last_p a column
    slice of an observation, as ``prepare_rollout`` gives it."""
    gen = torch.Generator().manual_seed(seed)
    h = torch.tanh(torch.randn(n, hidden, generator=gen))
    c = torch.randn(n, hidden, generator=gen) * 0.7
    s = torch.randn(n, social or hidden, generator=gen) * 0.5
    obsv = torch.rand(n, 8, 2, generator=gen) * 4 - 2
    noise = torch.rand(r * n, noise_len, generator=gen)
    h, c, s, obsv, noise = (t.to(device, dtype) for t in (h, c, s, obsv,
                                                          noise))
    return (h, c, s, obsv[:, -1]), noise


# --------------------------------------------------------------- the CPU
def _fake_kernel(calls):
    def kernel(params, prep, noise, n_next):
        calls.append(noise.shape[0])
        return torch.zeros(noise.shape[0], n_next, 4, dtype=prep[0].dtype)
    return kernel


def _run_case(case: str):
    """A rollout of ``case`` on the CPU: its output."""
    dtype = torch.float32 if case == "float32" else BF
    decoder = "lstm" if case == "lstm" else "fc"
    _, g = _model(16, 8, decoder)
    params = cast_params(g, dtype)
    prep, noise = _prep(5, 1, 16, 8, dtype, 1)
    if case == "grad":
        with torch.enable_grad():
            return decode_rollout(params, prep, noise, 3, decoder)
    with torch.no_grad():
        if case == "vmap":
            stacked = stack_modules([g, _model(16, 8, seed=1)[1]]).to(BF)
            return Members(2)(lambda gm, z: decode_rollout(gm, prep, z, 3),
                              (stacked,), torch.stack([noise, noise]))
        return decode_rollout(params, prep, noise, 3, decoder)


@pytest.mark.parametrize("case", ["cpu", "float32", "lstm", "grad", "vmap",
                                  "bf16 fc no_grad"])
def test_torch_decode_dispatch_keeps_the_plain_path(case, monkeypatch):
    """Each case but the last takes the plain loop (a real output, no
    kernel call, ``decode.fused`` unchanged); the last, the control,
    reaches the kernel once and counts it."""
    calls = []
    monkeypatch.setattr(gen_mod, "decode_rollout_bf16", _fake_kernel(calls))
    if case != "cpu":
        monkeypatch.setattr(gen_mod, "_on_card", lambda t: True)
    before = profiling.counters.get("decode.fused", 0)
    out = _run_case(case)
    gained = profiling.counters.get("decode.fused", 0) - before
    if case == "bf16 fc no_grad":
        assert calls == [5] and gained == 1
        return
    assert calls == [] and gained == 0
    assert bool(out.isfinite().all()) and bool((out != 0).any())


@pytest.mark.parametrize("on_card", [False, True])
def test_torch_decode_draws_read_the_prepared_rows(on_card, monkeypatch):
    """Noise row kk N + i is draw kk of agent i: the kernel gets the N
    prepared rows as they are, and the plain loop decodes as it would r
    copies of them in that order; ``prep_for_draws`` gives the rows each
    path reads."""
    calls = []
    if on_card:
        monkeypatch.setattr(gen_mod, "_on_card", lambda t: True)
        monkeypatch.setattr(
            gen_mod, "decode_rollout_bf16",
            lambda params, prep, noise, n_next: calls.append(
                (prep[0].shape[0], noise.shape[0])))
    _, g = _model(16, 8)
    params = cast_params(g, BF)
    prep, noise = _prep(5, 3, 16, 8, BF, 2)
    copies = tuple(torch.cat([t, t, t]) for t in prep)
    with torch.no_grad():
        got = decode_rollout(params, prep, noise, 4)
        read = prep_for_draws(params, prep, noise)
        if on_card:
            assert calls == [(5, 15)]
            assert all(a is b for a, b in zip(read, prep))
            return
        want = decode_rollout(params, copies, noise, 4)
    assert got.shape == (15, 4, 4) and torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(read, copies))


def _malformed(what: str):
    """Crowd-width bf16 operands on the CPU with one fault ``what``."""
    hidden, _, noise_len = CROWD
    _, g = _model(hidden, noise_len)
    params = cast_params(g, BF)
    (h, c, s, last_p), noise = _prep(6, 2, hidden, noise_len, BF, 3)
    if what == "hidden past the memory":
        h, c = (torch.cat([t, t[:, :16]], 1) for t in (h, c))
    elif what == "noise past the memory":
        noise = torch.cat([noise, noise, noise[:, :16]], 1)
    elif what == "hidden not the weights'":
        h, c = h[:, :32].contiguous(), c[:, :32].contiguous()
    elif what == "noise rows":
        noise = noise[:-1]
    elif what == "dtype":
        c = c.float()
    elif what == "contiguity":
        s = torch.cat([s, s], 1)[:, ::2]
    elif what == "last_p columns":
        last_p = torch.cat([last_p, last_p], 1)[:, ::2]
    elif what == "weight shape":
        params.decoder[1].w = params.decoder[1].w.t()
    elif what == "weight dtype":
        params.encoder.w = params.encoder.w.float()
    elif what == "layers":
        params.decoder = params.decoder[:3]
    return params, (h, c, s, last_p), noise


@pytest.mark.parametrize("what,match", [
    ("hidden past the memory", "hidden and social widths up to 64"),
    ("noise past the memory", "noise up to 64"),
    ("hidden not the weights'", "decoder.0.w has shape"),
    ("noise rows", "multiple of the prepared rows"), ("dtype", "c has dtype"),
    ("contiguity", "s must be contiguous"),
    ("last_p columns", "unit columns"),
    ("weight shape", "decoder.1.w has shape"),
    ("weight dtype", "encoder.w has dtype"), ("layers", "4-layer"),
    ("nothing", "runs on CUDA")])
def test_torch_fused_decode_wrapper_refuses_what_the_kernel_cannot_take(
        what, match):
    """Each fault raises before any launch; well-formed operands on the
    CPU raise only for the device."""
    params, prep, noise = _malformed(what)
    launches = dr.decode_rollout_bf16.launches
    with pytest.raises(ValueError, match=match):
        dr.decode_rollout_bf16(params, prep, noise, 12)
    assert dr.decode_rollout_bf16.launches == launches


# -------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(n: int, r: int, seed: int, widths=CROWD):
    dev = _card()
    hidden, social, noise_len = widths
    _, g = _model(hidden, noise_len, seed=seed, device=dev, social=social)
    prep, noise = _prep(n, r, hidden, noise_len, BF, seed + 1, dev, social)
    return cast_params(g, BF), prep, noise


def _fused(params, prep, noise):
    with torch.no_grad():
        return decode_rollout(params, prep, noise, 12)


def _hold(params, prep, noise, what: str) -> None:
    """The fused decode within the bounds of the plain loop on the same
    operands (grad on, nothing requiring it), one launch."""
    launches = dr.decode_rollout_bf16.launches
    fused = _fused(params, prep, noise)
    assert dr.decode_rollout_bf16.launches == launches + 1
    with torch.enable_grad():
        plain = decode_rollout(params, prep, noise, 12)
    assert dr.decode_rollout_bf16.launches == launches + 1
    assert fused.dtype == plain.dtype == BF
    assert fused.shape == plain.shape == (noise.shape[0], 12, 4)
    f, p = fused.float(), plain.float()
    gap = (f - p).abs()
    print(f"{what}: largest gap {gap.max().item():.4g}, mean gap "
          f"{gap.mean().item():.4g}, largest |plain| "
          f"{p.abs().max().item():.4g}, rows off by more than 1e-2: "
          f"{(gap.amax((1, 2)) > 1e-2).float().mean():.4f} "
          f"[{torch.cuda.get_device_name()}]")
    assert bool((gap <= ATOL + RTOL * p.abs()).all())
    assert gap.mean().item() <= MEAN_GAP


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 64, 1000, 65_537])
@pytest.mark.parametrize("r", [1, 20])
def test_torch_fused_decode_matches_the_plain_loop_cuda(n, r):
    _hold(*_card_case(n, r, 7 + n + r), f"n={n} r={r}")


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(16, 16, 8), (32, 32, 16),
                                    (48, 48, 24), (64, 64, 64),
                                    (21, 13, 7)])
def test_torch_fused_decode_matches_the_plain_loop_at_other_widths_cuda(
        widths):
    """Each padded shape of the library (``SHAPES``) at a width of the
    command line's family (h, h, h / 2) or, (64, 64, 64), its widest
    noise; and odd widths that pad unevenly."""
    assert dr.padded_shape(*widths) is not None
    _hold(*_card_case(1000, 20, sum(widths), widths), f"widths {widths}")


@pytest.mark.cuda
def test_torch_fused_decode_repeats_its_bits_cuda():
    params, prep, noise = _card_case(1000, 20, 3)
    assert torch.equal(_fused(params, prep, noise),
                       _fused(params, prep, noise))


@pytest.mark.cuda
def test_torch_fused_decode_replays_in_a_graph_cuda():
    """Captured in a CUDA graph, the launch replays the eager bits, on the
    inputs as captured and after they change in place; the capture counts
    nothing and records one launch, credited once a replay."""
    params, prep, noise = _card_case(4096, 20, 5)
    eager = _fused(params, prep, noise)
    graph = torch.cuda.CUDAGraph()
    before = sa.launch_counts()
    with sa.captured_launches() as record:
        with torch.cuda.graph(graph):
            out = _fused(params, prep, noise)
    assert sa.launch_counts() == before
    assert record == {(dr.decode_rollout_bf16, "launches"): 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    noise.copy_(torch.rand_like(noise.float()).to(BF))
    prep[0].mul_(0.5)
    graph.replay()
    sa.credit_launches(record, times=2)
    assert torch.equal(out, _fused(params, prep, noise))
    assert (sa.launch_counts()[(dr.decode_rollout_bf16, "launches")]
            == before[(dr.decode_rollout_bf16, "launches")] + 3)


@pytest.mark.cuda
def test_torch_fused_decode_reads_no_stale_memory_cuda():
    """The output comes from memory filled with NaN first: every element
    is written, and the bits are those of a clean launch."""
    params, prep, noise = _card_case(65_537, 3, 11)
    res = []
    for _ in range(2):
        junk = torch.full((1 << 26,), float("nan"), device="cuda")
        del junk
        res.append(_fused(params, prep, noise))
        torch.cuda.synchronize()
    assert bool(res[0].isfinite().all())
    assert torch.equal(res[0], res[1])
