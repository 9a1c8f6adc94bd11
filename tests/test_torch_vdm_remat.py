"""The UNet's remat policies in the port (street_crafter_tpu_torch.models.
vdm.unet: "nothing", "flash0", "flash01", "flash", "flashx", "dots")
against the JAX package's, on the CPU: the gradients of one seeded
cotangent under the same policy, on the same parameters (seeded random
values, carried across by ``convert``). Tolerance: 1e-3 of each leaf's
largest |gradient| (test_torch_vdm_train.py's train-step tolerance: f32
sums of two libraries in another order, through a backward). The sites
each policy keeps, and its gradients against no remat:
test_torch_vdm_train.py.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from street_crafter_tpu.models.vdm.unet import UNetConfig as JUNetConfig
from street_crafter_tpu_torch.models.vdm import convert as PCV
from street_crafter_tpu_torch.models.vdm.unet import UNetConfig
from tests.test_torch_vdm_options import _inputs, _jax_out, _pair, _port_out

GRAD_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------- remat policies

# tests/test_torch_vdm_train.py's policy UNet with one res block a level
# (attention at two levels, S = 1024 and 256, head dim 64: 7 flash sites)
POLICY_KW = dict(model_channels=64, num_head_channels=64, channel_mult=(1, 1),
                 attention_resolutions=(1, 2), context_dim=48,
                 adm_in_channels=24, num_res_blocks=1, remat=True)


@pytest.mark.parametrize("policy", ["nothing", "flash0", "flash01", "flash",
                                    "flashx", "dots"])
def test_remat_policy_gradients_match_jax(policy):
    """The gradients of a seeded cotangent under the same policy in both
    packages."""
    inp = _inputs(1)
    jun, params, unet = _pair(JUNetConfig(**POLICY_KW, remat_policy=policy),
                              UNetConfig(**POLICY_KW, remat_policy=policy),
                              inp)

    def loss(p):
        return jnp.sum(_jax_out(jun, p, inp) * jnp.asarray(inp["cot"]))

    jgrads = PCV.state_dict_from_jax(jax.jit(jax.grad(loss))(params),
                                     PCV.unet_name_map(unet.cfg), "grads")
    (_port_out(unet, inp) * torch.tensor(inp["cot"])).sum().backward()
    assert len(jgrads) == len(list(unet.parameters()))
    for name, p in unet.named_parameters():
        # a length-1 context: the cross-attention's q, k and norm2 get no
        # gradient (None in torch, zeros in JAX)
        got = torch.zeros_like(p) if p.grad is None else p.grad
        want = jgrads[name]
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_RTOL * scale if scale > 0 else err == 0, name
