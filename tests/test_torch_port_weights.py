"""The port's weight bridge (utils/weights.py), seeded init, and its import
boundary: the package must never import JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from ref_geotransformer_tpu.models import GeoTransformer as JaxGeoTransformer
from ref_geotransformer_tpu.models import init_model_variables
from ref_geotransformer_tpu.utils.convert_checkpoint import convert_state_dict
from ref_geotransformer_tpu_torch.models.geotransformer import GeoTransformer
from ref_geotransformer_tpu_torch.utils.jax_init import jax_init_parameters
from ref_geotransformer_tpu_torch.utils.weights import from_jax_variables, init_parameters, load_jax_variables
from tests.torch_port_utils import ROOT, port_config, tiny4_config


@pytest.fixture(scope="module")
def jax_variables():
    cfg = tiny4_config()
    return cfg, jax.device_get(init_model_variables(JaxGeoTransformer(cfg), cfg, jax.random.key(0)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_bridge_loads_strict_with_upstream_names(jax_variables):
    cfg, variables = jax_variables
    model = load_jax_variables(GeoTransformer(port_config(cfg)), variables)
    sd = model.state_dict()
    p = variables["params"]
    np.testing.assert_array_equal(sd["backbone.encoder1_1.norm.norm.weight"].numpy(),
                                  p["backbone"]["encoder1_1"]["norm"]["scale"])
    np.testing.assert_array_equal(sd["backbone.encoder2_1.norm_conv.norm.bias"].numpy(),
                                  p["backbone"]["encoder2_1"]["norm_conv"]["bias"])
    np.testing.assert_array_equal(sd["transformer.in_proj.weight"].numpy(), p["transformer"]["in_proj"]["kernel"].T)
    attn = p["transformer"]["transformer"]["layers_0"]["attention"]
    np.testing.assert_array_equal(sd["transformer.transformer.layers.0.attention.attention.proj_p.weight"].numpy(),
                                  attn["attention"]["proj_p_kernel"].T)
    np.testing.assert_array_equal(sd["transformer.transformer.layers.0.attention.norm.weight"].numpy(),
                                  attn["norm"]["scale"])
    np.testing.assert_array_equal(sd["backbone.encoder1_1.KPConv.kernel_points"].numpy(),
                                  variables["buffers"]["backbone"]["encoder1_1"]["KPConv"]["kernel_points"])
    assert sd["optimal_transport.alpha"].shape == ()


def test_bridge_is_the_inverse_of_convert_checkpoint(jax_variables):
    _, variables = jax_variables
    back = convert_state_dict(from_jax_variables(variables))
    for collection in ("params", "buffers"):
        want = dict(_flat(variables[collection]))
        got = dict(_flat(back[collection]))
        assert sorted(got) == sorted(want), collection
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


def test_bridge_rejects_unknown_variables():
    with pytest.raises(KeyError):
        from_jax_variables({"params": {"backbone": {"mystery": {"gamma": np.zeros(3, np.float32)}}}})


def test_port_model_dispositions_match_the_jax_package(jax_variables):
    cfg, variables = jax_variables
    model = GeoTransformer(port_config(cfg))
    for path, value in _flat(variables["buffers"]):
        key = ".".join(path)
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value, err_msg=key)


def test_init_parameters_is_seeded(jax_variables):
    cfg = port_config(jax_variables[0])
    a = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(3)).state_dict()
    b = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(3)).state_dict()
    c = init_parameters(GeoTransformer(cfg), torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.in_proj.weight"], c["transformer.in_proj.weight"])
    assert float(a["backbone.encoder1_1.KPConv.weights"].abs().max()) > 0


def test_jax_init_parameters_draws_the_jax_weights(jax_variables):
    """The numpy draw of the JAX package's initial weights for key 0 against
    `init_model_variables(..., jax.random.key(0))`: every tensor within 1e-6
    of its largest magnitude (the last bit: the jitted init rounds the
    uniform's scale and shift once, as an FMA, and XLA's f32 erf_inv and
    log1p round otherwise); a wrong key, path or count misses by the
    weights' own size."""
    cfg, variables = jax_variables
    want = load_jax_variables(GeoTransformer(port_config(cfg)), variables).state_dict()
    got = jax_init_parameters(GeoTransformer(port_config(cfg)), 0).state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        scale = max(float(want[key].abs().max()), 1e-30)
        assert float((value - want[key]).abs().max()) <= 1e-6 * scale, key
    other = jax_init_parameters(GeoTransformer(port_config(cfg)), 1).state_dict()
    assert not torch.equal(other["transformer.in_proj.weight"], got["transformer.in_proj.weight"])


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX, the JAX package and
    PIL unimported (the card machine has no PIL; the port reads PNGs
    itself). The walk reaches only packages with an __init__.py: it must
    reach the trainers, the tester, the three experiments' modules, the
    native kernels' bindings and the tools."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ref_geotransformer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "exp = 'experiments.geotransformer_3dmatch_stage4.'\n"
        "lm = 'experiments.geotransformer_modelnet_rpmnet_stage4.'\n"
        "kitti = 'experiments.geotransformer_kitti_stage5.'\n"
        "want = {pkg.__name__ + '.' + n for n in ('engine.trainer', 'engine.tester', 'engine.checkpoint',\n"
        "        'engine.cli', 'data.loader', 'data.datasets.threedmatch', 'utils.feature_dump', exp + 'config',\n"
        "        exp + 'dataset', exp + 'trainval', exp + 'test', exp + 'eval', exp + 'fixture',\n"
        "        'engine.iter_trainer', 'data.datasets.linemod', 'data.datasets.bop_utils',\n"
        "        'data.datasets.modelnet', 'data.datasets.png', 'config.modelnet', lm + 'config', lm + 'dataset',\n"
        "        lm + 'trainval_encoder', lm + 'test', lm + 'fixture', 'config.kitti', 'data.calibration',\n"
        "        'data.datasets.kitti', kitti + 'config', kitti + 'dataset', kitti + 'trainval', kitti + 'test',\n"
        "        kitti + 'eval', kitti + 'fixture', 'models.cordi', lm + 'train_cordi', 'parallel.multihost',\n"
        "        'parallel.mesh', 'parallel.dp', 'utils.visualization', 'utils.convert_checkpoint',\n"
        "        'models.factory', 'models.correspondence', 'models.attention', 'models.embedding',\n"
        "        'ops.vector_angle', 'ops.metrics', 'ops.se3', 'ops.neighbors', 'ops.partition', 'native',\n"
        "        'tools.downsample_kitti', 'tools.overfit_probe', exp + 'eval_dgr', 'utils.jax_init',\n"
        "        'utils.neighbor_tables')}\n"
        "assert want <= set(names), sorted(want - set(names))\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ref_geotransformer_tpu')\n"
        "       or m.startswith(('jax.', 'ref_geotransformer_tpu.')))\n"
        "assert not bad, bad\n"
        "pil = sorted(m for m in sys.modules if m == 'PIL' or m.startswith('PIL.'))\n"
        "assert not pil, pil\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
