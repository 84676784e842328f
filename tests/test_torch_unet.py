"""The port's UNet against the JAX UNet at the tiny parity config.

The JAX model gets random params (its zero-initialized leaves randomized too,
so the output convs and biases are covered), carried into the port with
``state_dict_from_jax``. Forward and the x-VJP are held at the repo's UNet
parity bar, rtol 1e-3 / atol 5e-4 (tests/test_convert_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osmosis_tpu.models import UNetConfig as JaxUNetConfig
from osmosis_tpu.models import UNetModel as JaxUNet
from osmosis_tpu_torch.models.convert import init_unet, state_dict_from_jax
from osmosis_tpu_torch.models.unet import UNetConfig, UNetModel, unet_config_from_yaml

TINY_KW = dict(
    image_size=32,
    in_channels=4,
    model_channels=32,
    out_channels=8,
    num_res_blocks=1,
    attention_resolutions=(4,),
    channel_mult=(1, 2),
    num_heads=4,
    num_head_channels=16,
    use_scale_shift_norm=True,
    resblock_updown=True,
    use_new_attention_order=False,
)


def _jax_params(cfg, seed=0):
    model = JaxUNet(cfg)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)))
    rng = np.random.default_rng(seed + 100)

    def randomize(leaf):
        a = np.asarray(leaf)
        if not a.any():
            a = (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return model, jax.tree_util.tree_map(randomize, params)


def _port_model(params, cfg):
    model = UNetModel(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg))
    return model.requires_grad_(False).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(use_new_attention_order=True),
    dict(resblock_updown=False),
    dict(use_scale_shift_norm=False),
], ids=["legacy_attention", "new_attention_order", "conv_resample", "no_scale_shift"])
def test_forward_and_x_vjp_match_jax(variant):
    kw = dict(TINY_KW, **variant)
    jmodel, params = _jax_params(JaxUNetConfig(**kw), seed=len(variant))
    tmodel = _port_model(params, UNetConfig(**kw))

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    ts = np.array([17.0, 433.0], dtype=np.float32)
    g = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)

    @jax.jit  # one XLA compile costs far less on the CPU than op-by-op dispatch
    def jax_forward_and_vjp(p, xx, tt, gg):
        y, pull = jax.vjp(lambda a: jmodel.apply(p, a, tt), xx)
        return y, pull(gg)[0]

    jy, jdx = jax_forward_and_vjp(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    ty = tmodel(xt, torch.from_numpy(ts))
    (tdx,) = torch.autograd.grad(ty, xt, torch.from_numpy(g))

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-3, atol=5e-4)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-3, atol=5e-4)


def test_state_dict_round_trips_and_names_match_reference():
    cfg = UNetConfig(**TINY_KW)
    _, params = _jax_params(JaxUNetConfig(**TINY_KW))
    sd = state_dict_from_jax(params, cfg)
    model = UNetModel(cfg)
    # strict load: every reference name is present, no extra ones
    model.load_state_dict(sd)
    back = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    for name in ("time_embed.0.weight", "input_blocks.0.0.weight",
                 "input_blocks.1.0.in_layers.0.weight", "input_blocks.1.0.emb_layers.1.weight",
                 "input_blocks.1.0.out_layers.3.weight", "input_blocks.3.0.skip_connection.weight",
                 "middle_block.1.qkv.weight", "middle_block.1.proj_out.weight",
                 "middle_block.1.norm.weight", "output_blocks.0.0.in_layers.2.weight",
                 "out.0.weight", "out.2.weight"):
        assert name in sd, name


def test_seeded_init_zeroes_output_convs_and_is_reproducible():
    cfg = UNetConfig(**TINY_KW)
    a, b = init_unet(cfg, seed=3), init_unet(cfg, seed=3)
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    sd = a.state_dict()
    assert not sd["out.2.weight"].any()
    assert not sd["input_blocks.1.0.out_layers.3.weight"].any()
    assert not sd["middle_block.1.proj_out.weight"].any()


def test_config_from_preset_yaml_matches_jax():
    from osmosis_tpu.config import load_yaml
    from osmosis_tpu.models.unet import unet_config_from_yaml as jax_from_yaml

    um = load_yaml("configs/osmosis_sample_config.yaml")["unet_model"]
    ours, theirs = unet_config_from_yaml(um), jax_from_yaml(um)
    for f in ("image_size", "in_channels", "out_channels", "model_channels", "channel_mult",
              "attention_resolutions", "num_head_channels", "use_scale_shift_norm",
              "resblock_updown", "num_res_blocks"):
        assert getattr(ours, f) == getattr(theirs, f), f
