"""The port's run scripts (cartnet_tpu_torch/scripts/*.sh) against the JAX
package's (scripts/*.sh).

Each script runs under bash with a ``python`` first on PATH that records
its argv and exits 0, so nothing trains and no dataset is read; the
environment sets ``ADP_DATASET`` and the script gets stub arguments
(``"$@"``). The port's script must make as many calls as the JAX one, in
the same order, each with the same arguments after its module; each
trainer call must give the same configuration through
``cartnet_tpu_torch.cli`` as through the JAX CLI (every field the two
``Config``s share, section by section; dtypes by name), and each
aggregate call must parse under ``cartnet_tpu_torch.aggregate``.
"""

import dataclasses
import os
import subprocess

import pytest

from cartnet_tpu_torch import aggregate, cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "cartnet_tpu_torch", "scripts")
JAX_DIR = os.path.join(REPO, "scripts")
STUB = ["--limit", "2", "--no_guard"]
# script: its arguments (the Comformer script takes the model first)
SCRIPTS = {
    "train_cartnet_adp.sh": STUB,
    "train_cartnet_jarvis.sh": STUB,
    "train_cartnet_megnet.sh": STUB,
    "train_comformer_adp.sh": ["ecomformer"] + STUB,
    "train_ecomformer_adp.sh": STUB,
    "train_icomformer_adp.sh": STUB,
    "run_ablations.sh": STUB,
    "run_no_atom_type.sh": STUB,
}
MODULES = {"cli": ("cartnet_tpu.cli", "cartnet_tpu_torch.cli"),
           "aggregate": ("cartnet_tpu.aggregate",
                         "cartnet_tpu_torch.aggregate")}


def _calls(script_dir, name, tmp_path):
    """The argv of every ``python`` call the script makes, in order (the
    shim writes each call's arguments on a line, each ended by 0x1f)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / f"{'port' if script_dir == PORT_DIR else 'jax'}.log"
    log.unlink(missing_ok=True)
    shim = bin_dir / "python"
    shim.write_text("#!/bin/bash\nprintf '%s\\x1f' \"$@\" >> \"$SHIM_LOG\"\n"
                    "echo >> \"$SHIM_LOG\"\n")
    shim.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               SHIM_LOG=str(log), ADP_DATASET="/data/adp")
    env.pop("TARGETS", None)
    subprocess.run(["bash", os.path.join(script_dir, name)]
                   + SCRIPTS[name], env=env, check=True, timeout=60)
    with open(log) as f:
        return [line.rstrip("\n").split("\x1f")[:-1] for line in f]


def _config_fields(cfg) -> dict:
    """A config's fields, section by section, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                x = getattr(v, g.name)
                if "dtype" in g.name:  # jnp.float32, torch.float32
                    x = getattr(x, "__name__", str(x).rsplit(".", 1)[-1])
                out[f"{f.name}.{g.name}"] = x
        else:
            out[f.name] = v
    return out


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_script_makes_the_jax_scripts_calls(name, tmp_path):
    from cartnet_tpu import cli as jcli
    assert os.access(os.path.join(PORT_DIR, name), os.X_OK)
    port = _calls(PORT_DIR, name, tmp_path)
    ref = _calls(JAX_DIR, name, tmp_path)
    assert len(port) == len(ref) > 0
    trainers = 0
    for ours, theirs in zip(port, ref):
        kind = theirs[1].rsplit(".", 1)[-1]
        assert theirs[:2] == ["-m", MODULES[kind][0]], theirs
        assert ours[:2] == ["-m", MODULES[kind][1]], ours
        assert ours[2:] == theirs[2:]
        if kind == "aggregate":
            args = aggregate.build_parser().parse_args(ours[2:])
            assert args.name and args.seeds
            continue
        trainers += 1
        assert ours[-len(STUB):] == STUB
        cfg = _config_fields(cli.args_to_config(
            cli.build_parser().parse_args(ours[2:])))
        jcfg = _config_fields(jcli.args_to_config(
            jcli.build_parser().parse_args(theirs[2:])))
        shared = cfg.keys() & jcfg.keys()
        assert len(shared) >= 40
        for k in sorted(shared):
            assert cfg[k] == jcfg[k], (k, cfg[k], jcfg[k])
        if "--dataset_path" in ours:  # ${ADP_DATASET:-...}
            assert cfg["data.path"] == "/data/adp"
    assert trainers == sum(1 for c in ref if c[1].endswith(".cli"))


def test_megnet_targets_keep_their_spaces(tmp_path):
    """The megnet script's targets are a bash array: "gap pbe" reaches
    the CLI as one argument."""
    targets = [c[c.index("--figshare_target") + 1]
               for c in _calls(PORT_DIR, "train_cartnet_megnet.sh", tmp_path)
               if "--figshare_target" in c]
    assert sorted(set(targets)) == ["bulk modulus", "e_form", "gap pbe",
                                    "shear modulus"]
