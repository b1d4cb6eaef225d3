"""JAX's loop flags on the port's CLI (socialways_tpu/cli/main.py:134, 181,
187, 381, 386): each of ``--fused-epochs``, ``--block-size``,
``--host-loop``, ``--latent-dim`` and ``--pallas`` on each of the six
commands that take a model builds JAX's config; ``train --fused-epochs``
prints, logs, checkpoints and evaluates at JAX's block boundaries (events
compared, not values: the two packages draw from different RNGs); every
command line of JAX's README parses with the port's parser.  On the CPU
at a toy width (hidden 16, batch 64, K 4)."""

import json
import os
import re
import shlex

import numpy as np
import pytest

from socialways_tpu.cli import main as jax_cli
from socialways_tpu.data.toy import make_toy_npz_arrays
from socialways_torch.cli import main as cli

H, BATCH, K = 16, 64, 4
SMALL = ["--h-size", str(H), "--batch-size", str(BATCH), "--k", str(K)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def toy_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("loopflags") / "toy.npz")
    np.savez(path, **make_toy_npz_arrays())
    return path


def jax_args(argv):
    return jax_cli.build_parser().parse_args(jax_cli._apply_recipe(argv))


#: each command's required arguments
COMMANDS = {
    "train": ["train", "--data", "x.npz"],
    "evaluate": ["evaluate", "--data", "x.npz"],
    "predict": ["predict", "--data", "x.npz", "--model-file", "m.npz"],
    "sweep": ["sweep", "--data", "x.npz"],
    "eth-ucy": ["eth-ucy", "--data-dir", "d"],
    "simulate": ["simulate"],
}
FLAGS = {"--fused-epochs": ["--fused-epochs"],
         "--block-size": ["--block-size", "3"],
         "--host-loop": ["--host-loop"],
         "--latent-dim": ["--latent-dim", "7"],
         "--pallas": ["--pallas"]}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("command", list(COMMANDS))
def test_torch_loop_flag_builds_jax_config(command, flag):
    """The loop fields of the config (``latent_dim``, ``use_pallas``,
    ``epoch_on_device``) and the loop arguments (``fused_epochs``,
    ``block_size``) equal JAX's for the same command line."""
    argv = COMMANDS[command] + FLAGS[flag]
    want_args = jax_args(argv)
    want = jax_cli._cfg_from_args(want_args)
    args = cli.parse_args(["--cpu"] + argv)
    build = (cli._train_cfg if command in ("train", "sweep", "eth-ucy")
             else cli._cfg_from_args)
    got = build(args)
    for field in ("latent_dim", "use_pallas", "epoch_on_device"):
        assert getattr(got, field) == getattr(want, field), field
    for name in ("fused_epochs", "block_size"):
        assert getattr(args, name) == getattr(want_args, name), name


def _events(out: str):
    """The printout as events: numbers masked, paths cut to their file
    name; dropped are the lines that name the device or the package and
    the "new best" lines, which follow the values."""
    keep = []
    for line in out.splitlines():
        if line.startswith(("hidden dim", "instance-noise", "new best")) or (
                "# training samples" in line):
            continue
        line = re.sub(r"(\S*/)+", "", line)
        line = re.sub(r"time = [0-9.]+s", "time = Ts", line)
        keep.append(re.sub(r"-?\d+\.\d+|nan|inf", "X", line))
    return keep


def _log(path):
    with open(path) as fh:
        return [(r["kind"], r["epoch"], r.get("n_block"))
                for r in map(json.loads, fh)]


@pytest.mark.parametrize("loop", [
    ["--epochs", "5", "--block-size", "2", "--test-interval", "2",
     "--save-interval", "4"],
    ["--epochs", "7", "--block-size", "3", "--test-interval", "2",
     "--save-interval", "2"],
    ["--epochs", "4", "--test-interval", "2", "--save-interval", "4"],
], ids=["block2_tail", "block3_misaligned", "gcd_block"])
def test_torch_fused_epochs_events_match_jax(loop, toy_npz, tmp_path,
                                             capsys):
    """One print and one metrics row (``n_block``) a block, the block's
    " (n fused epochs)", save and eval where a block ends on their
    interval (a misaligned ``--block-size`` skips boundaries, as in JAX),
    and the final checkpoint: the same events as JAX's run."""
    runs = {}
    for name, main in (("jax", jax_cli.main), ("torch", cli.main)):
        mdir, log = str(tmp_path / f"{name}_m"), str(tmp_path / f"{name}.l")
        argv = (["--cpu", "train", "--data", toy_npz, "--fused-epochs",
                 "--model-dir", mdir, "--metrics-log", log] + SMALL + loop)
        capsys.readouterr()
        assert main(argv) == 0
        runs[name] = (_events(capsys.readouterr().out), _log(log),
                      sorted(os.listdir(mdir)))
    assert runs["torch"] == runs["jax"]
    out, log, _ = runs["torch"]
    blocks = [r for r in log if r[0] == "train"]
    assert len(blocks) == sum("Epc=" in line for line in out)
    assert any("fused epochs)" in line for line in out)


def test_torch_fused_epochs_profile_the_second_block(toy_npz, tmp_path,
                                                     capsys):
    """``--profile-dir`` traces the second block, after the first
    block's print."""
    prof = str(tmp_path / "prof")
    assert cli.main(["--cpu", "train", "--data", toy_npz, "--fused-epochs",
                     "--block-size", "2", "--epochs", "6",
                     "--test-interval", "6", "--save-interval", "6",
                     "--model-dir", str(tmp_path / "m"), "--profile-dir",
                     prof] + SMALL) == 0
    lines = capsys.readouterr().out.splitlines()
    epc = [i for i, line in enumerate(lines) if "Epc=" in line]
    (wrote,) = [i for i, line in enumerate(lines)
                if line == f"wrote profiler trace to {prof}"]
    assert len(epc) == 3 and epc[0] < wrote < epc[1]
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as fh:
        assert json.load(fh)["traceEvents"]


def _readme_commands():
    """Every ``python -m socialways_tpu.cli.main`` command of JAX's
    README (its quick start, README.md:25-69), continuation lines joined
    and comments cut."""
    with open(os.path.join(REPO, "README.md")) as fh:
        text = fh.read().replace("\\\n", " ")
    cmds = []
    for line in text.splitlines():
        if line.startswith("python -m socialways_tpu.cli.main "):
            line = line.split("#")[0]
            cmds.append(shlex.split(line)[3:])
    return cmds


@pytest.mark.parametrize("argv", _readme_commands(),
                         ids=lambda a: "-".join(a[:2]))
def test_torch_parses_jax_readme_commands(argv):
    args = cli.parse_args(argv)
    assert args.command == argv[0]
    assert jax_args(argv).command == argv[0]
