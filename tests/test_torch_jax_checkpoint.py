"""street_crafter_tpu_torch/scripts/convert_jax_checkpoint.py: the JAX
package's orbax checkpoints, written by its own functions
(``utils.checkpoint.save_checkpoint``, ``models.vdm.weights.
save_vdm_params``), read with tensorstore alone and written as the port's
files; the port's loaders read them back.

Each kind is held against the in-memory conversion of the same JAX state
(``models.gs.convert.train_state_from_dict``, ``models.vdm.convert.
engine_params_from_jax`` / ``vdm_train_state_from_jax``): equal, leaf for
leaf. A scene state, parameters alone, the tiny engine's parameters and a
fine-tune state with two Adam groups (random moments, counts and steps, so
that no leaf is a default). The script run in a fresh process imports no
JAX.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_port_helpers import jax_tree_to_numpy, random_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomised(tree, seed: int):
    """Every float leaf of a JAX tree drawn anew, every integer leaf moved:
    no leaf keeps its default value."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if not hasattr(x, "dtype"):
            return x
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(rng.normal(size=x.shape), x.dtype)
        if jnp.issubdtype(x.dtype, jnp.integer):
            return x + 3
        return x
    return jax.tree_util.tree_map(leaf, tree)


def _same(a, b, path="") -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def jax_scene(tmp_path_factory):
    from street_crafter_tpu.config import default_config
    from street_crafter_tpu.runner import create_scene
    from tests.synthetic_scene import make_scene
    root = tmp_path_factory.mktemp("ckpt_scene")
    cfg = default_config()
    cfg.source_path = make_scene(str(root / "data"), num_frames=2)
    cfg.model_path = str(root / "jax_model")
    cfg.data.cameras = [0, 1]
    cfg.optim.capacity_bkgd = 512
    cfg.optim.capacity_obj = 64
    cfg.optim.capacity_sky = 128
    from street_crafter_tpu.training.gs_trainer import init_train_state
    from street_crafter_tpu.utils.checkpoint import save_checkpoint
    scene = create_scene(cfg)
    state = _randomised(init_train_state(scene.params), 0)
    save_checkpoint(str(root / "jax_model"), 7, state)
    return scene, root, state


def test_scene_train_state_round_trips(jax_scene):
    from street_crafter_tpu_torch.models.gs.convert import (
        train_state_from_dict, train_state_to_numpy)
    from street_crafter_tpu_torch.scripts.convert_jax_checkpoint import main
    from street_crafter_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_train_checkpoint)
    _, root, state = jax_scene
    assert state.adam_actors is not None and state.dstate_bkgd is not None
    out = main(["scene", str(root / "jax_model"), str(root / "port_model")])
    assert out.endswith(os.path.join("checkpoints", "iteration_7"))
    got, it = load_train_checkpoint(str(root / "port_model"))
    assert it == 7 and got.step == int(state.step)
    want = train_state_from_dict(jax_tree_to_numpy(state))
    _same(train_state_to_numpy(got), train_state_to_numpy(want))
    params, _ = load_checkpoint(str(root / "port_model"), 7)
    assert torch.equal(params.bkgd.xyz, want.params.bkgd.xyz)


def test_scene_params_alone_round_trip(jax_scene):
    from street_crafter_tpu.utils.checkpoint import save_checkpoint
    from street_crafter_tpu_torch.models.gs.convert import (params_from_dict,
                                                            params_to_dict)
    from street_crafter_tpu_torch.scripts.convert_jax_checkpoint import main
    from street_crafter_tpu_torch.utils.checkpoint import (
        TRAIN_STATE_FILE, checkpoint_dir, load_checkpoint)
    scene, root, _ = jax_scene
    params = _randomised(scene.params, 1)
    save_checkpoint(str(root / "jax_params"), 3, params)
    main(["scene", str(root / "jax_params"), str(root / "port_params"),
          "--iteration", "3"])
    got, it = load_checkpoint(str(root / "port_params"))
    assert it == 3
    assert not os.path.exists(os.path.join(
        checkpoint_dir(str(root / "port_params"), 3), TRAIN_STATE_FILE))
    want = params_from_dict(jax_tree_to_numpy(params))
    _same(params_to_dict(got), params_to_dict(want))


def test_script_imports_no_jax(jax_scene):
    """The scene conversion in a fresh process: no jax, flax or orbax
    module is loaded."""
    _, root, _ = jax_scene
    code = (
        "import sys\n"
        "from street_crafter_tpu_torch.scripts.convert_jax_checkpoint "
        "import main\n"
        f"main(['scene', {str(root / 'jax_model')!r}, "
        f"{str(root / 'port_fresh')!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'street_crafter_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.isfile(root / "port_fresh" / "checkpoints"
                          / "iteration_7" / "train_state.pt")


@pytest.fixture(scope="module")
def tiny_engine():
    from street_crafter_tpu.models.vdm.engine import \
        EngineConfig as JEngineConfig
    from street_crafter_tpu.models.vdm.engine import \
        VideoDiffusionEngine as JEngine
    jeng = JEngine(JEngineConfig.tiny(num_frames=2))
    params = random_params(jax.eval_shape(
        lambda k: jeng.init_params(k, 32, 32), jax.random.PRNGKey(0)), 5)
    return jeng, jax.tree_util.tree_map(jnp.asarray, params)


def test_vdm_params_round_trip(tiny_engine, tmp_path):
    from street_crafter_tpu.models.vdm.weights import save_vdm_params
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.models.vdm import convert as PCV
    from street_crafter_tpu_torch.models.vdm.engine import \
        VideoDiffusionEngine
    from street_crafter_tpu_torch.models.vdm.weights import (
        engine_from_config, load_vdm_params)
    from street_crafter_tpu_torch.scripts.convert_jax_checkpoint import main
    _, params = tiny_engine
    save_vdm_params(str(tmp_path / "jax_vdm"), params)
    dst = str(tmp_path / "port" / "vdm.pt")
    main(["vdm", str(tmp_path / "jax_vdm"), dst, "diffusion.tiny=true"])
    cfg = default_config()
    cfg.diffusion.tiny = True
    cfg.diffusion.ckpt_path = dst
    engine = VideoDiffusionEngine(engine_from_config(cfg.diffusion), "cpu")
    assert load_vdm_params(engine, cfg.diffusion) == dst
    want = PCV.engine_params_from_jax(jax_tree_to_numpy(params), engine.cfg)
    for part, module in engine.modules().items():
        sd = module.state_dict()
        assert set(sd) == set(want[part])
        for k, v in want[part].items():
            assert torch.equal(sd[k], v.to(sd[k].dtype)), (part, k)
    # the engine's refusal of an orbax directory names the script
    cfg.diffusion.ckpt_path = str(tmp_path / "jax_vdm")
    with pytest.raises(NotImplementedError, match="convert_jax_checkpoint"):
        load_vdm_params(engine, cfg.diffusion)


def test_vdm_train_state_round_trips(tiny_engine, tmp_path):
    from street_crafter_tpu.training.vdm_trainer import init_vdm_train_state
    from street_crafter_tpu.utils.checkpoint import save_checkpoint
    from street_crafter_tpu_torch.models.vdm import convert as PCV
    from street_crafter_tpu_torch.models.vdm.engine import EngineConfig
    from street_crafter_tpu_torch.scripts.convert_jax_checkpoint import main
    from street_crafter_tpu_torch.utils.checkpoint import load_vdm_checkpoint
    from tests.test_torch_vdm_train import GROUPS
    jeng, params = tiny_engine
    state = _randomised(init_vdm_train_state(jeng, params,
                                             param_groups=GROUPS), 2)
    save_checkpoint(str(tmp_path / "jax_ft"), 4, state)
    main(["vdm_train", str(tmp_path / "jax_ft"), str(tmp_path / "port_ft"),
          "diffusion.tiny=true"])
    got, it = load_vdm_checkpoint(str(tmp_path / "port_ft"))
    want = PCV.vdm_train_state_from_jax(jax.device_get(state),
                                        EngineConfig.tiny(num_frames=2))
    assert it == want.step == 3
    assert set(want.count) == {"base", "slow"} and want.mu and want.nu
    _same(dataclasses.asdict(got), dataclasses.asdict(want))
