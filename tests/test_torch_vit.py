"""The port's ViT (sparkdl_torch/models/vit.py) against the JAX package's
(sparkdl_tpu/models/vit.py) on the same weights through the ViT weight
bridge, both attention paths ("full"; "flash", the JAX kernel in interpret
mode on the CPU and the port's plain version); load_hf_vit against the JAX
converter and the HF forward; the registry route at 224 px and the
named-image transformers over ViT-B/16.

Tolerances, as max |diff| <= tol * max |ref|: 1e-5 for the tiny modules
(float32 on both sides, only summation order differs), 1e-4 against the
HF forward (its attention sums in another order and through SDPA) and
through the transformers (torch_parity.NET_TOL).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import NET_TOL, assert_close, named_image_parity

from sparkdl_tpu.models import vit as jvit
from sparkdl_torch.models import vit as tvit
from sparkdl_torch.models.convert import vit_flax_to_torch, vit_torch_to_flax

TOL = 1e-5
CLASSES = 5


@pytest.fixture(scope="module")
def tiny_variables():
    model = jvit.ViTModel(config=jvit.ViTConfig.tiny(), num_classes=CLASSES)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    v = jax.device_get(flax.core.meta.unbox(v))
    # non-trivial CLS token and LayerNorm scales (the init has 0 and 1)
    r = np.random.default_rng(1)
    v["params"]["cls_token"] = r.standard_normal((1, 1, 32)).astype(np.float32)
    v["params"]["layernorm"]["scale"] = (1 + 0.1 * r.standard_normal(32)).astype(np.float32)
    return v


def _images(seed=21, b=3, size=32):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _port(variables, attn_impl="full", include_top=True):
    cfg = tvit.ViTConfig.tiny(attn_impl=attn_impl)
    module = tvit.ViTModel(cfg, num_classes=CLASSES, include_top=include_top)
    if not include_top:
        variables = {"params": {k: v for k, v in variables["params"].items()
                                if k != "classifier"}}
    module.load_state_dict(vit_flax_to_torch(variables, module=module))
    return module.eval()


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_tiny_matches_jax(tiny_variables, attn_impl):
    x = _images()
    jmodel = jvit.ViTModel(config=jvit.ViTConfig.tiny(attn_impl=attn_impl),
                           num_classes=CLASSES)
    jf, jp = jmodel.apply(tiny_variables, x)
    with torch.no_grad():
        f, p = _port(tiny_variables, attn_impl)(torch.from_numpy(x))
        f2, p2 = _port(tiny_variables, attn_impl, include_top=False)(torch.from_numpy(x))
    assert f.shape == (3, 32) and p.shape == (3, CLASSES)
    assert_close(f.numpy(), jf, TOL)
    assert_close(p.numpy(), jp, TOL)
    assert p2 is None
    assert_close(f2.numpy(), f.numpy(), TOL)


def test_flash_matches_full_in_the_port(tiny_variables):
    x = torch.from_numpy(_images(seed=4))
    with torch.no_grad():
        f_full, p_full = _port(tiny_variables, "full")(x)
        f_flash, p_flash = _port(tiny_variables, "flash")(x)
    assert_close(f_flash.numpy(), f_full.numpy(), TOL)
    assert_close(p_flash.numpy(), p_full.numpy(), TOL)


def test_bridge_round_trip(tiny_variables):
    back = vit_torch_to_flax(vit_flax_to_torch(tiny_variables))
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(tiny_variables)]
    for (_, a), (_, b) in zip(flat(back), flat(tiny_variables)):
        np.testing.assert_array_equal(a, b)


def test_bridge_rejects_what_it_does_not_know(tiny_variables):
    bad = {"params": {**tiny_variables["params"], "extra": {"kernel": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unknown ViT parameter"):
        vit_flax_to_torch(bad)
    module = tvit.ViTModel(tvit.ViTConfig.tiny(), num_classes=CLASSES + 1)
    with pytest.raises(RuntimeError):
        module.load_state_dict(vit_flax_to_torch(tiny_variables))
    with pytest.raises(ValueError, match="do not match"):
        vit_flax_to_torch(tiny_variables, module=tvit.ViTModel(
            tvit.ViTConfig.tiny(), include_top=False))


def test_wrong_input_size_rejected(tiny_variables):
    with pytest.raises(ValueError, match="32x32"):
        _port(tiny_variables)(torch.zeros(1, 16, 16, 3))


def _hf_config(**kw):
    transformers = pytest.importorskip("transformers")
    return transformers, transformers.ViTConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, **kw)


@pytest.mark.parametrize("attn_impl", ["full", "flash"])
def test_load_hf_vit_features(attn_impl):
    transformers, hf_cfg = _hf_config()
    torch.manual_seed(0)
    hf = transformers.ViTModel(hf_cfg, add_pooling_layer=False).eval()
    cfg, sd = tvit.load_hf_vit(hf)
    jcfg, jvars = jvit.load_hf_vit(hf)
    assert cfg.num_layers == jcfg.num_layers == 2
    assert cfg.layer_norm_eps == jcfg.layer_norm_eps
    # the same state dict as the JAX converter's tree through the bridge
    want_sd = vit_flax_to_torch(jvars)
    assert sorted(sd) == sorted(want_sd)
    for k, v in sd.items():
        assert torch.equal(v, want_sd[k]), k

    import dataclasses

    module = tvit.ViTModel(dataclasses.replace(cfg, attn_impl=attn_impl),
                           include_top=False)
    module.load_state_dict(sd)
    x = _images(seed=6, b=2)
    with torch.no_grad():
        ref = hf(pixel_values=torch.from_numpy(x).permute(0, 3, 1, 2)
                 ).last_hidden_state[:, 0]
        feats, probs = module.eval()(torch.from_numpy(x))
    assert probs is None
    assert_close(feats.numpy(), ref.numpy(), 1e-4)
    jf, _ = jvit.ViTModel(config=jcfg, include_top=False).apply(jvars, x)
    assert_close(feats.numpy(), jf, TOL)


def test_load_hf_vit_classifier():
    transformers, hf_cfg = _hf_config(num_labels=7)
    torch.manual_seed(1)
    hf = transformers.ViTForImageClassification(hf_cfg).eval()
    cfg, sd = tvit.load_hf_vit(hf)
    assert cfg.num_classes == 7
    module = tvit.ViTModel(cfg, include_top=True)
    module.load_state_dict(sd)
    x = _images(seed=7, b=2)
    with torch.no_grad():
        logits = hf(pixel_values=torch.from_numpy(x).permute(0, 3, 1, 2)).logits
        _, probs = module.eval()(torch.from_numpy(x))
    assert_close(probs.numpy(), torch.softmax(logits, -1).numpy(), 1e-4)
    jcfg, jvars = jvit.load_hf_vit(hf)
    _, jp = jvit.ViTModel(config=jcfg, include_top=True).apply(jvars, x)
    assert_close(probs.numpy(), jp, TOL)


def test_init_vit_follows_the_jax_init():
    m = tvit.init_vit_(tvit.ViTModel(tvit.ViTConfig.tiny(hidden_size=64)), seed=2)
    again = tvit.init_vit_(tvit.ViTModel(tvit.ViTConfig.tiny(hidden_size=64)), seed=2)
    for (k, a), (_, b) in zip(m.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.all(m.cls_token == 0)
    assert abs(m.pos_embed.std().item() - 0.02) < 0.004
    w = m.layer[0].intermediate.weight
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.1
    assert torch.all(m.layer[0].intermediate.bias == 0)
    assert torch.all(m.layernorm.weight == 1)


def test_registry_route_at_224():
    """ViTB16 through the registry: random weights only (its pretrained
    weights come through load_hf_vit), 224 px inputs only."""
    from sparkdl_torch import DeepImageFeaturizer, LocalDataFrame
    from sparkdl_torch.image import imageArrayToStructBGR
    from sparkdl_torch.models.registry import build_torch_model, get_entry

    entry = get_entry("ViTB16")
    assert (entry.input_size, entry.feature_dim, entry.preprocess, entry.source) == (
        (224, 224), 768, "tf", "hf")
    module = build_torch_model("ViTB16", None, include_top=False, device="cpu")
    assert isinstance(module, tvit.ViTModel) and module.config == tvit.ViTConfig.b16()
    with torch.no_grad():
        f, p = module(torch.zeros(1, 224, 224, 3))
        assert f.shape == (1, 768) and p is None and torch.isfinite(f).all()
        with pytest.raises(ValueError, match="224x224"):
            module(torch.zeros(1, 160, 160, 3))
    for weights in ("imagenet", "/nope/vit.h5"):
        with pytest.raises(ValueError, match="load_hf_"):
            build_torch_model("ViTB16", weights, device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    df = LocalDataFrame.from_rows([{"image": imageArrayToStructBGR(img)}])
    feat = DeepImageFeaturizer(modelName="ViTB16", inputCol="image", outputCol="f",
                               batchSize=2, device="cpu")
    with pytest.raises(ValueError, match="weights='random'"):
        feat.transform(df).collect()


@pytest.mark.parametrize("cls_name", ["DeepImageFeaturizer", "DeepImagePredictor"])
def test_named_image_transformer_matches_jax(monkeypatch, cls_name):
    """ViT-B/16 (full width and depth) behind both transformers, against
    the JAX ones on the same weights."""
    named_image_parity(monkeypatch, "ViTB16", cls_name, NET_TOL)


def test_tp1_keeps_plain_layers_and_state_dict_names(tiny_variables):
    """At tp = 1 (no mesh, or a mesh whose tp axis is 1) q/k/v, the output
    and the MLP stay plain ``nn.Linear`` s with the names the converters,
    the HF loader and the zoo's weights use, and a seeded build gives the
    same tensors; at tp = 2 the same names hold this rank's slices."""
    from sparkdl_torch.partition import make_mesh

    names = set(vit_flax_to_torch(tiny_variables))
    built = []
    for mesh in (None, make_mesh(dp=1, tp=1)):
        torch.manual_seed(0)
        m = tvit.ViTModel(tvit.ViTConfig.tiny(), num_classes=CLASSES, mesh=mesh)
        assert set(m.state_dict()) == names
        blk = m.layer[0]
        assert all(type(layer) is torch.nn.Linear for layer in (
            blk.attention.query, blk.attention.key, blk.attention.value,
            blk.attention.output_dense, blk.intermediate, blk.output))
        built.append(m.state_dict())
    assert all(torch.equal(built[0][k], built[1][k]) for k in names)
    tp2 = tvit.ViTModel(tvit.ViTConfig.tiny(), num_classes=CLASSES,
                        mesh=make_mesh(dp=1, tp=2, devices=[0, 1]))
    assert set(tp2.state_dict()) == names
    assert tp2.layer[0].attention.query.weight.shape == (16, 32)
    assert tp2.layer[0].output.weight.shape == (32, 32)  # [hidden, 64 / tp]
