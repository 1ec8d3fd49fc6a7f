"""The harness finds every piece by name, takes new pieces without edits,
makes the same traffic from the same seed, and prints the contract's line."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness, traffic

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    assert c.spec["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert c.traffic["mode"] in ("infer", "train")
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert c.limits, f"portbench/limits/{cell}.json is missing"
    assert harness.program_config(c.spec) is not None  # the program states the configuration's sizes


def test_every_metric_config_and_mix_has_its_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")), m["name"]
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", w["traffic"] + ".json"))


def test_added_files_are_found_without_edits(tmp_path):
    """A copy of the benchmark with a new configuration, mix, metric and
    cell, each only a new file and an entry, resolves through the same code."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    spec = json.load(open(os.path.join(ROOT, "portbench", "configs", "3dmatch-stage4.json")))
    spec["name"] = "3dmatch-democaps"
    (root / "portbench" / "configs" / "3dmatch-democaps.json").write_text(json.dumps(spec))
    mix = json.load(open(os.path.join(ROOT, "portbench", "traffic", "fragments-infer.json")))
    mix["pool"]["keep"] = [0.3, 0.6]
    (root / "portbench" / "traffic" / "fragments-mixed.json").write_text(json.dumps(mix))
    (root / "portbench" / "metrics" / "window_pairs.py").write_text("def read(run):\n    return run.attempted\n")
    (root / "portbench" / "limits" / "3dmatch-infer-democaps.json").write_text('{"transform": 1.0}')
    bench["configs"].append({"name": "3dmatch-democaps", "source": "x", "file": "portbench/configs/3dmatch-democaps.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "3dmatch-infer-democaps", "config": "3dmatch-democaps",
                               "traffic": "fragments-mixed", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "window_pairs", "unit": "pairs", "better": "higher", "source": "host_clock",
                               "layer": "entry and host path", "moves": "pairs_per_s",
                               "workloads": ["3dmatch-infer-democaps"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("3dmatch-infer-democaps", root=str(root))
    assert cell.spec["name"] == "3dmatch-democaps" and cell.traffic["pool"]["keep"] == [0.3, 0.6]
    assert cell.limits == {"transform": 1.0}
    assert [m["name"] for m in cell.per_layer][-1] == "window_pairs"
    assert harness.load_reader("window_pairs", root=str(root))(type("R", (), {"attempted": 7})()) == 7


@pytest.mark.parametrize("mix", ["fragments-infer", "scans-infer"])
def test_pools_repeat_for_a_seed_and_differ_for_another(mix):
    tr = traffic.load(ROOT, mix)
    tr["pool"]["pairs"] = 3
    big = 2**31 + 12345
    a, b, c = (traffic.make_pool(ROOT, tr, s, 30720) for s in (big, big, big + 1))
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert any(not np.array_equal(x["src_points"], y["src_points"]) for x, y in zip(a, c))
    assert traffic.send_order(big, 5, 12) == traffic.send_order(big, 5, 12)
    assert sorted(traffic.send_order(big, 5, 10)[:5]) == list(range(5))


def test_fragment_pairs_keep_their_ground_truth():
    """The moved source, mapped by its composed ground truth, lands where
    the original source's ground truth puts it."""
    tr = traffic.load(ROOT, "fragments-infer")
    tr["pool"]["pairs"] = 2
    pair = traffic.make_pool(ROOT, tr, 5, 30720)[0]
    gt0 = np.load(os.path.join(ROOT, tr["pool"]["gt"]))
    src0 = np.load(os.path.join(ROOT, tr["pool"]["src"]))
    moved = pair["src_points"][pair["src_masks"]].astype(np.float64)
    mapped = moved @ pair["transform"][:3, :3].T.astype(np.float64) + pair["transform"][:3, 3]
    orig = src0 @ gt0[:3, :3].T + gt0[:3, 3]
    # every mapped point is one of the original source's mapped points
    d = np.min(np.linalg.norm(mapped[:50, None, :] - orig[None, :, :], axis=-1), axis=1)
    assert d.max() < 1e-4


def test_result_line_has_the_contract_keys(monkeypatch, capsys):
    """run.py's last line: correct, attempted, failed, metrics, device, and
    breakdown when traced, then the checks beside their limits."""
    import torch
    from portbench import run

    fake = {"metrics": {"pairs_per_s": {"value": 1.0, "unit": "pairs/s"}}, "memory_peak_bytes": 5,
            "checks": {"transform": 1e-7}, "attempted": 3, "failed": 0,
            "busy_s": 0.5, "window_s": 1.0, "breakdown": {"device_ops": [], "idle_gaps": []}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(fake))
    monkeypatch.setattr(harness, "power_limit", lambda: None)
    for trace, keys in ((0, ["correct", "attempted", "failed", "metrics", "device", "checks"]),
                        (1, ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"])):
        assert run.main(["--workload", "3dmatch-infer", "--seed", "1", "--seconds", "1", "--trace", str(trace)]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(line) == keys
        assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        assert ("busy_s" in line["device"]) == bool(trace)


def test_no_result_with_jax_loaded(monkeypatch, capsys):
    import torch
    from portbench import run

    fake = {"metrics": {}, "memory_peak_bytes": 5, "checks": {"transform": 0.0}, "attempted": 1, "failed": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(fake))
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.main(["--workload", "3dmatch-infer", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch
    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "3dmatch-infer", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_a_run_loads_no_jax():
    """Every module a run loads, the reference's and the program's included,
    compared by whole top-level name: the program's name begins with the
    JAX package's, so a prefix test would be wrong."""
    code = (
        "import sys, portbench.run, portbench.harness, portbench.check, portbench.control, portbench.trace\n"
        "from portbench import harness\n"
        "import json\n"
        "for w in json.load(open('BENCHMARK.json'))['workloads']:\n"
        "    c = harness.resolve(w['name'])\n"
        "    for key in ('model', 'infer', 'train_step', 'train_state', 'config'):\n"
        "        harness._entry(c.spec['program'][key])\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        harness.load_reader(m['name'])\n"
        "import portbench.reference.geotransformer, portbench.work.step, portbench.work.counts\n"
        "print(harness.forbidden_modules())\n"
        "assert 'ref_geotransformer_tpu_torch' in {m.split('.')[0] for m in sys.modules}\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[]"
    assert harness.forbidden_modules.__doc__


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ref_geotransformer_tpu_torchx", sys)
    assert "ref_geotransformer_tpu_torchx" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_no_result_from_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run finds no program: it exits with another code than 0 and
    prints no result (the card's presence faked, so the run gets that far)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from portbench import run\n"
            "sys.exit(run.main(['--workload', '3dmatch-infer', '--seed', '1', '--seconds', '1', '--trace', '0']))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    done = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, env=env)
    assert done.returncode != 0
    assert done.stdout == ""
    assert "ref_geotransformer_tpu_torch" in done.stderr
