"""PyTorch port: eval_dgr, the .sh wrappers and the overfit probe, against
the JAX repository's scripts.

* `eval_dgr` prints the JAX script's per-epoch summaries and picks its best
  epoch, on synthetic dumps (the recipe of tests/test_offline_eval_e2e.py)
  in two epoch directories, one registering right and one wrong;
* each wrapper runs its JAX twin's command sequence (a fake `python` /
  `python3` on PATH logs argv; script paths map to module names), also when
  a command fails half way through `eval_all.sh`;
* the probe's pairs and scaled capacities equal `_flagship_setup`'s and
  `run_probe`'s raw draws exactly;
* at tiny widths, the probe loop's step-0 evaluation and its two train
  steps match JAX's `make_eval_step` / `make_train_step` over the stacked
  batch, at the same weights and target keys (scaled error 2e-5).

The JAX scripts put directories on sys.path and import a bare `config` and
`eval`, so they run only in subprocesses here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax
import jax.numpy as jnp

from ref_geotransformer_tpu.engine import make_eval_step, make_train_step
from ref_geotransformer_tpu.engine.state import TrainState as JaxTrainState
from ref_geotransformer_tpu.engine.state import make_optimizer
from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.utils.convert_checkpoint import convert_state_dict
from ref_geotransformer_tpu_torch.data.benchmark_3dmatch import write_log_file
from ref_geotransformer_tpu_torch.engine.state import TrainState
from ref_geotransformer_tpu_torch.experiments.geotransformer_3dmatch_stage4 import eval_dgr
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.tools import overfit_probe
from ref_geotransformer_tpu_torch.utils.jax_init import jax_init_parameters
from tests.torch_port_utils import ROOT, jax_target_keys, port_config, port_target_keys, scaled_error, tiny4_config

ENV_KEYS = ("REF_GT_3DMATCH_ROOT", "REF_GT_OUTPUT_ROOT", "REF_GT_CAPS_SCALE", "REF_GT_NEIGHBOR_LIMITS", "REF_GT_LR",
            "REF_GT_LR_DECAY", "REF_GT_USE_AUG", "REF_GT_COMPILE_CACHE")
EXP_3DMATCH = "geotransformer_3dmatch_stage4"
EXP_KITTI = "geotransformer_kitti_stage5"


@pytest.fixture
def clean_env(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    return {k: v for k, v in os.environ.items() if k not in ENV_KEYS}


def _jax_subprocess(code, env, timeout=180):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env=dict(env, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    return proc


# ---------------------------------------------------------------------------
# eval_dgr
# ---------------------------------------------------------------------------

def _random_transform(seed):
    rng = np.random.default_rng(seed)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = Rotation.random(random_state=seed).as_matrix()
    t[:3, 3] = rng.uniform(-1, 1, 3)
    return t


def _write_dumps(feature_dir, scene, pairs, right):
    """tests/test_offline_eval_e2e.py's dumps (copied): exact correspondences
    and a stored transform equal to the ground truth when `right`, else the
    transform of another seed."""
    feature_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i, (a, b) in enumerate(pairs):
        transform = _random_transform(i)
        estimated = transform if right else _random_transform(i + 50)
        n_c, n_corr = 40, 120
        src_corr = rng.uniform(-1, 1, (n_corr, 3)).astype(np.float32)
        ref_corr = src_corr @ transform[:3, :3].T + transform[:3, 3]
        gt_map = np.zeros((n_c, n_c), np.float32)
        idx = rng.integers(0, n_c, 30)
        jdx = rng.integers(0, n_c, 30)
        gt_map[idx, jdx] = rng.uniform(0.2, 0.9, 30)
        sel = rng.integers(0, 30, 25)
        np.savez_compressed(
            feature_dir / f"{scene}_{a}_{b}.npz",
            ref_points=rng.normal(size=(500, 3)).astype(np.float32),
            src_points=rng.normal(size=(500, 3)).astype(np.float32),
            ref_points_f=rng.normal(size=(200, 3)).astype(np.float32),
            src_points_f=rng.normal(size=(200, 3)).astype(np.float32),
            ref_points_c=rng.normal(size=(n_c, 3)).astype(np.float32),
            src_points_c=rng.normal(size=(n_c, 3)).astype(np.float32),
            ref_feats_c=rng.normal(size=(n_c, 8)).astype(np.float32),
            src_feats_c=rng.normal(size=(n_c, 8)).astype(np.float32),
            ref_node_corr_indices=idx[sel],
            src_node_corr_indices=jdx[sel],
            ref_corr_points=ref_corr if right else rng.normal(size=(n_corr, 3)).astype(np.float32),
            src_corr_points=src_corr,
            corr_scores=np.ones(n_corr, np.float32),
            gt_node_corr_overlaps=gt_map,
            estimated_transform=estimated,
            transform=transform,
            overlap=0.5,
        )


def _write_benchmark(root, scene, pairs, num_fragments=60):
    bench_dir = root / "metadata" / "benchmarks" / "3DMatch" / scene
    bench_dir.mkdir(parents=True)
    write_log_file(str(bench_dir / "gt.log"), [
        {"test_pair": [a, b], "num_fragments": num_fragments, "transform": _random_transform(i)}
        for i, (a, b) in enumerate(pairs)])
    with open(bench_dir / "gt.info", "w") as f:
        for a, b in pairs:
            f.write(f"{a}\t{b}\t{num_fragments}\n")
            for row in np.eye(6, dtype=np.float32):
                f.write("\t".join(str(x) for x in row) + "\n")


def test_eval_dgr_matches_the_jax_script(tmp_path, clean_env, monkeypatch, capsys):
    """Epoch 1 registers wrong, epoch 2 right, epoch 3 has no directory: both
    scripts print the same two summaries and pick epoch 2. The JAX script
    rounds every summary value, and its eval's summary holds the "scenes"
    dict, so unchanged it raises on the first epoch; it runs here with its
    `eval_one_epoch` wrapped to hand back the scalars only, and the full
    summaries are compared too."""
    scene, pairs = "7-scenes-redkitchen", [(0, 3), (1, 5), (2, 8)]
    _write_benchmark(tmp_path / "data", scene, pairs)
    features = tmp_path / "out" / EXP_3DMATCH / "features"
    _write_dumps(features / "3DMatch-epoch-1", scene, pairs, right=False)
    _write_dumps(features / "3DMatch-epoch-2", scene, pairs, right=True)
    env = dict(clean_env, REF_GT_3DMATCH_ROOT=str(tmp_path / "data"), REF_GT_OUTPUT_ROOT=str(tmp_path / "out"))
    exp_dir = os.path.join(ROOT, "experiments", EXP_3DMATCH)
    argv = ["--benchmark", "3DMatch", "--method", "lgr", "--epochs", "1", "3"]

    # one process: the script as it stands, then with the wrapped eval_one_epoch
    summaries_path = tmp_path / "jax_summaries.json"
    code = (
        "import json, runpy, sys, traceback\n"
        f"sys.argv = ['eval_dgr.py', *{argv!r}]\n"
        "try:\n"
        f"    runpy.run_path({os.path.join(exp_dir, 'eval_dgr.py')!r}, run_name='__main__')\n"
        "    unchanged = ''\n"
        "except Exception:\n"
        "    unchanged = traceback.format_exc()\n"
        "print('--- wrapped ---')\n"
        f"sys.path.insert(0, {exp_dir!r})\n"
        "import eval as eval_mod\n"
        "summaries = []\n"
        "one_epoch = eval_mod.eval_one_epoch\n"
        "def scalars(args, cfg):\n"
        "    summary = one_epoch(args, cfg)\n"
        "    summaries.append(summary)\n"
        "    return {k: v for k, v in summary.items() if k != 'scenes'}\n"
        "eval_mod.eval_one_epoch = scalars\n"
        "import eval_dgr\n"
        f"sys.argv = ['eval_dgr.py', *{argv!r}]\n"
        "eval_dgr.main()\n"
        f"json.dump({{'summaries': summaries, 'unchanged': unchanged}}, open({str(summaries_path)!r}, 'w'), "
        "default=float)\n"
    )
    proc = _jax_subprocess(code, env)
    assert proc.returncode == 0, proc.stderr
    jax_out = json.loads(summaries_path.read_text())
    unchanged = jax_out["unchanged"]
    assert "TypeError" in unchanged and "round" in unchanged, unchanged
    wrapped_out = proc.stdout.split("--- wrapped ---\n", 1)[1]
    want_lines = [line for line in wrapped_out.splitlines() if line.startswith(("epoch ", "best epoch"))]

    for key, value in env.items():
        if key.startswith("REF_GT_"):
            monkeypatch.setenv(key, value)
    got_summaries = []
    one_epoch = eval_dgr.eval_one_epoch

    def recording(args, cfg):
        got_summaries.append(one_epoch(args, cfg))
        return got_summaries[-1]

    monkeypatch.setattr(eval_dgr, "eval_one_epoch", recording)
    capsys.readouterr()
    best = eval_dgr.main(argv)
    got_lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith(("epoch ", "best epoch"))]

    assert len(want_lines) == 3 and want_lines[-1] == "best epoch 2: RR 1.0000", want_lines
    assert got_lines == want_lines
    assert best[0] == 2 and best[1] is got_summaries[1]
    want_summaries = jax_out["summaries"]
    assert [s["RR"] for s in want_summaries] == [0.0, 1.0]
    assert len(got_summaries) == len(want_summaries) == 2
    for got, want in zip(got_summaries, want_summaries):
        assert set(got) == set(want)
        assert set(got["scenes"]) == set(want["scenes"])
        for scene_abbr, result in got["scenes"].items():
            assert result == pytest.approx(want["scenes"][scene_abbr], rel=1e-12, abs=1e-12)
        assert {k: v for k, v in got.items() if k != "scenes"} == pytest.approx(
            {k: v for k, v in want.items() if k != "scenes"}, rel=1e-12, abs=1e-12)


def test_eval_dgr_without_epoch_directories(tmp_path, clean_env, monkeypatch, capsys):
    monkeypatch.setenv("REF_GT_OUTPUT_ROOT", str(tmp_path))
    assert eval_dgr.main(["--epochs", "20", "40"]) is None
    assert "no per-epoch feature dirs found" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the .sh wrappers
# ---------------------------------------------------------------------------

FAKE_PYTHON = """#!/bin/bash
echo "$(basename "$0") $*" >> "$PROBE_LOG"
echo "$PYTHONPATH" >> "$PROBE_LOG.pythonpath"
case " $* " in *" epoch-$PROBE_FAIL_AT "*) exit 3;; esac
"""


def _run_wrapper(tmp_path, script, args, tag, fail_at=""):
    """Run `bash script args` with the fake interpreters first on PATH;
    returns (exit code, stdout, commands as (module, args...), PYTHONPATHs, interpreter names)."""
    bin_dir = tmp_path / "bin"
    if not bin_dir.exists():
        bin_dir.mkdir()
        for name in ("python", "python3"):
            (bin_dir / name).write_text(FAKE_PYTHON)
            (bin_dir / name).chmod(0o755)
    log = tmp_path / f"{tag}.log"
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", PROBE_LOG=str(log), PROBE_FAIL_AT=fail_at)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(["bash", script, *args], capture_output=True, text=True, timeout=60, env=env, cwd=tmp_path)
    commands, interpreters = [], set()
    for line in log.read_text().splitlines() if log.exists() else []:
        words = line.split()
        interpreters.add(words[0])
        if words[1] == "-m":
            module, rest = words[2], words[3:]
        else:  # a JAX script path: experiments/<exp>/<name>.py
            parts = words[1].split("/")
            module, rest = f"{parts[-2]}.{parts[-1][:-3]}", words[2:]
        commands.append((module.split("experiments.")[-1], *rest))
    paths = log.with_name(log.name + ".pythonpath")
    pythonpaths = set(paths.read_text().splitlines()) if paths.exists() else set()
    return proc.returncode, proc.stdout, commands, pythonpaths, interpreters


WRAPPER_CASES = [
    (EXP_3DMATCH, "eval.sh", [], ""),
    (EXP_3DMATCH, "eval.sh", ["epoch-7", "3DLoMatch"], ""),
    (EXP_3DMATCH, "eval_all.sh", [], ""),
    (EXP_3DMATCH, "eval_all.sh", ["val"], ""),
    (EXP_3DMATCH, "eval_all.sh", ["3DLoMatch"], "25"),
    (EXP_KITTI, "eval.sh", [], ""),
    (EXP_KITTI, "eval.sh", ["epoch-3"], ""),
]


@pytest.mark.parametrize("exp,script,args,fail_at", WRAPPER_CASES,
                         ids=[f"{e.split('_')[1]}-{s}-{'-'.join(a) or 'defaults'}{'-fail' + f if f else ''}"
                              for e, s, a, f in WRAPPER_CASES])
def test_wrapper_runs_the_jax_sequence(tmp_path, exp, script, args, fail_at):
    jax_rc, jax_out, jax_cmds, _, jax_names = _run_wrapper(
        tmp_path, os.path.join(ROOT, "experiments", exp, script), args, "jax", fail_at)
    rc, out, cmds, pythonpaths, names = _run_wrapper(
        tmp_path, os.path.join(ROOT, "ref_geotransformer_tpu_torch", "experiments", exp, script), args, "port", fail_at)
    assert cmds == jax_cmds and out == jax_out and rc == jax_rc
    assert names == {"python3"} and jax_names == {"python"}
    assert pythonpaths == {ROOT}  # the repository root, so `python3 -m` finds the package from any directory
    if fail_at:
        assert rc != 0 and cmds[-1][:3] == (f"{exp}.test", "--snapshot", f"epoch-{fail_at}")
        assert len(cmds) == 2 * (int(fail_at) - 20) + 1
    else:
        assert rc == 0 and cmds
    if script == "eval_all.sh" and not fail_at:
        assert len(cmds) == 42 and cmds[0][:3] == (f"{exp}.test", "--snapshot", "epoch-20")


# ---------------------------------------------------------------------------
# the overfit probe
# ---------------------------------------------------------------------------

def _jax_probe_draws(tmp_path, env, runs):
    """The raw clouds that JAX's `_flagship_setup` and `run_probe` pad, the
    transforms they build pyramids with and the scaled capacities, for each
    (scale, pairs) in `runs`: the pyramid builder, the weight
    initialization and the train state are stubbed, and the run stops there."""
    out = tmp_path / "jax_draws.npz"
    code = (
        "import numpy as np, sys\n"
        "import ref_geotransformer_tpu.data as data, ref_geotransformer_tpu.models as models\n"
        "import ref_geotransformer_tpu.engine as engine\n"
        "import __graft_entry__ as g\n"
        "pad_points = data.pad_points\n"
        "record = {}\n"
        "def padded(points, capacity):\n"
        "    record['raw'].append(np.array(points))\n"
        "    return pad_points(points, capacity)\n"
        "def inputs(*args, transform=None, **kwargs):\n"
        "    record['transforms'].append(np.array(transform))\n"
        "    return {'x': np.zeros(1, np.float32)}\n"
        "class Stop(Exception):\n"
        "    pass\n"
        "def stop(*args, **kwargs):\n"
        "    raise Stop\n"
        "data.pad_points, data.build_registration_inputs = padded, inputs\n"
        "models.init_model_variables, engine.create_train_state = (lambda *a, **k: None), stop\n"
        "flagship = g._flagship_setup\n"
        "def setup(scale=1.0):\n"
        "    out = flagship(scale=scale)\n"
        "    record['caps'] = out[0].capacities\n"
        "    return out\n"
        "g._flagship_setup = setup\n"
        "from tools.overfit_probe import run_probe\n"
        "saved = {}\n"
        f"for scale, pairs in {runs!r}:\n"
        "    record.update(raw=[], transforms=[])\n"
        "    try:\n"
        "        run_probe(steps=1, scale=scale, pairs=pairs)\n"
        "    except Stop:\n"
        "        pass\n"
        "    c = record['caps']\n"
        "    tag = f'{scale}_{pairs}'\n"
        "    saved[tag + '_caps'] = np.array([*c.points, c.gt_candidates, c.correspondence_limit, c.search_chunk])\n"
        "    saved[tag + '_limits'] = np.array(c.neighbor_limits)\n"
        "    saved[tag + '_transforms'] = np.stack(record['transforms'])\n"
        "    for i, r in enumerate(record['raw']):\n"
        "        saved[f'{tag}_raw{i}'] = r\n"
        f"np.savez({str(out)!r}, **saved)\n"
    )
    proc = _jax_subprocess(code, dict(env, REF_GT_COMPILE_CACHE=str(tmp_path / "xla_cache")))
    assert proc.returncode == 0, proc.stderr
    return dict(np.load(out))


def test_probe_pairs_equal_the_jax_probes_draws(tmp_path, clean_env):
    runs = [(0.06, 4), (0.25, 2)]
    want = _jax_probe_draws(tmp_path, clean_env, runs)
    for scale, pairs in runs:
        tag = f"{scale}_{pairs}"
        cfg = overfit_probe.probe_config(scale)
        caps = cfg.capacities
        np.testing.assert_array_equal(
            [*caps.points, caps.gt_candidates, caps.correspondence_limit, caps.search_chunk], want[tag + "_caps"])
        np.testing.assert_array_equal(caps.neighbor_limits, want[tag + "_limits"])
        raw = overfit_probe.probe_pairs(cfg, pairs)
        assert len(raw) == pairs
        for i, (ref, src, transform) in enumerate(raw):
            for got, name in ((ref, f"raw{2 * i}"), (src, f"raw{2 * i + 1}")):
                assert got.dtype == np.float32 and got.tobytes() == want[f"{tag}_{name}"].tobytes(), (tag, name)
            assert transform.dtype == np.float32
            assert transform.tobytes() == want[tag + "_transforms"][i].astype(np.float32).tobytes(), (tag, i)
        assert caps.points[0] * 3 // 4 == raw[0][0].shape[0]


PROBE_PAIRS, PROBE_STEPS = 2, 2


def _to_jax(tree):
    if isinstance(tree, dict):
        return {key: _to_jax(value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_jax(value) for value in tree)
    return jnp.asarray(tree.numpy())


def test_probe_loop_matches_jax_steps_at_tiny_widths():
    """The probe's loop (evaluation at step 0, then two guarded Adam updates
    over both pairs, an evaluation after each) against the JAX package's
    eval and train steps over the stacked batch of the same pairs (the
    port's pyramids, `pair_inputs`, in both), from the same weights, the
    target sampler fed the same keys in both. The weights are the probe's
    own (`jax_init_parameters`, key 0), handed to JAX through its checkpoint
    converter."""
    cfg = tiny4_config()
    port_cfg = port_config(cfg)
    inputs = overfit_probe.pair_inputs(port_cfg, overfit_probe.probe_pairs(port_cfg, PROBE_PAIRS), "cpu")
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *[_to_jax(data) for data in inputs])
    port = jax_init_parameters(GeoTransformer(port_cfg), 0)
    variables = convert_state_dict(port.state_dict())  # the JAX package's converter: upstream names -> flax
    variables.pop("skipped")
    model = JaxGeoTransformer(cfg)
    tx, _ = make_optimizer(cfg.optim, PROBE_STEPS)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], buffers=variables["buffers"],
                          opt_state=tx.init(variables["params"]), tx=tx)
    m = n = cfg.capacities.points[-1]
    keys = np.random.default_rng(5).uniform(size=(PROBE_STEPS * PROBE_PAIRS, m * n)).astype(np.float32)
    with jax.default_matmul_precision("highest"), jax_target_keys(keys) as order:
        want_eval = jax.device_get(make_eval_step(model, cfg)(state, batch))
        train_step = make_train_step(model, cfg, donate=False)
        want_losses = []
        rng = jax.random.key(1)
        for _ in range(PROBE_STEPS):
            rng, sub = jax.random.split(rng)
            state, losses = train_step(state, batch, sub)
            want_losses.append(float(losses["loss"]))
    assert len(order) == PROBE_STEPS * PROBE_PAIRS

    port_state = TrainState(port, port_cfg.optim, steps_per_epoch=PROBE_STEPS)
    drawn = []

    def next_index():
        drawn.append(len(drawn))
        return drawn[-1]

    with port_target_keys(keys, next_index):
        rows = overfit_probe.probe_loop(port, port_state, inputs, PROBE_STEPS, 1, torch.Generator())
    assert len(drawn) == PROBE_STEPS * PROBE_PAIRS and port_state.count == PROBE_STEPS
    assert [row["step"] for row in rows] == [0, 1, 2] and all(row["skipped_steps"] == 0 for row in rows)
    assert "train_loss" not in rows[0] and set(rows[0]) == {"step", "skipped_steps", *want_eval}
    errors = {key: scaled_error(np.float32(rows[0][key]), want_eval[key]) for key in want_eval}
    errors.update({f"train_loss {i + 1}": scaled_error(np.float32(rows[i + 1]["train_loss"]), np.float32(want))
                   for i, want in enumerate(want_losses)})
    print("scaled errors: " + ", ".join(f"{k} {v:.2e}" for k, v in errors.items()))
    assert max(errors.values()) <= 2e-5, errors
    assert want_losses[0] != want_losses[1]
