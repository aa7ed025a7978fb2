"""The port's release packaging (``maest_tpu_torch/packaging``: the HF AST
export, ``push_to_hub``, MAEST-layout ``.pt`` files and the ONNX export)
against the JAX package's, at a tiny geometry with the same weights
carried across by ``state_from_jax_params``. The files the port writes
must equal the JAX package's; the traced ONNX module's outputs must be
within 1e-5 of JAX's logits (the bound of tests/test_onnx_export.py).
``safetensors`` and ``transformers`` are optional: the tests that need
them skip where they are absent. No test reaches the network."""

import filecmp
import json
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maest_tpu.models.config import MAESTConfig as JaxConfig
from maest_tpu.models.vit import MAESTNet as JaxNet
from maest_tpu.models.vit import init_params
from maest_tpu.packaging import hf_ast as jax_hf
from maest_tpu.packaging import onnx_export as jax_onnx
from maest_tpu_torch.checkpoints import load_into, state_from_jax_params
from maest_tpu_torch.checkpoints.convert import load_checkpoint_file, normalize_state
from maest_tpu_torch.models import surgery
from maest_tpu_torch.models.config import MAESTConfig
from maest_tpu_torch.models.registry import build_config
from maest_tpu_torch.models.vit import MAESTNet
from maest_tpu_torch.packaging import hf_ast, onnx_export

GEOM = dict(img_size=(96, 312), embed_dim=64, depth=2, num_heads=4,
            num_classes=40)
LABELS = [f"l{i}" for i in range(40)]


@pytest.fixture(scope="module")
def weights():
    """JAX params with random heads, and the port's model of them."""
    jcfg = JaxConfig(**GEOM)
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    params["head_linear"] = {
        "kernel": rng.standard_normal((64, 40)).astype("f4") * 0.3,
        "bias": rng.standard_normal(40).astype("f4") * 0.1}
    tcfg = MAESTConfig(**GEOM)
    net = load_into(MAESTNet(tcfg), state_from_jax_params(params, tcfg)).eval()
    return params, jcfg, net


def _jax_logits(params, jcfg, mel):
    """JAX logits of (B, T, F) mels."""
    x = jnp.asarray(mel).transpose(0, 2, 1)[..., None]
    return np.asarray(JaxNet(jcfg).apply({"params": params}, x,
                                         train=False)[0])


@pytest.mark.parametrize("arch", ["discogs-maest-5s-pw-129e",
                                  "discogs-maest-10s-dw-75e",
                                  "discogs-maest-20s-pw-129e",
                                  "discogs-maest-30s-pw-129e-519l"])
def test_config_dicts_match_jax(arch):
    from maest_tpu.models.registry import build_config as jax_build

    cfg, jcfg = build_config(arch), jax_build(arch)
    assert hf_ast._ast_max_length(cfg) == jax_hf._ast_max_length(jcfg)
    labels = [f"t{i}" for i in range(cfg.num_classes)]
    assert hf_ast.ast_config_dict(cfg, labels) == jax_hf.ast_config_dict(
        jcfg, labels)
    assert hf_ast.ast_config_dict(cfg) == jax_hf.ast_config_dict(jcfg)
    assert (hf_ast.feature_extractor_config(cfg)
            == jax_hf.feature_extractor_config(jcfg))


@pytest.mark.parametrize("source", ["module", "wrapper", "state"])
def test_save_pretrained_files_equal_jax(weights, tmp_path, source):
    """config.json, preprocessor_config.json, feature_extraction_maest.py
    and model.safetensors, byte for byte, from the module, the ``MAEST``
    wrapper or the state dict with its config."""
    pytest.importorskip("safetensors")
    from maest_tpu_torch.api import MAEST

    params, jcfg, net = weights
    model, cfg = {"module": (net, None), "wrapper": (MAEST(net.cfg, net), None),
                  "state": (net.state_dict(), net.cfg)}[source]
    ours = hf_ast.save_pretrained(model, cfg, str(tmp_path / "ours"), LABELS)
    ref = jax_hf.save_pretrained(params, jcfg, str(tmp_path / "ref"), LABELS)
    names = ["config.json", "preprocessor_config.json",
             "feature_extraction_maest.py", "model.safetensors"]
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == sorted(names)
    for name in names:
        assert filecmp.cmp(f"{ours}/{name}", f"{ref}/{name}", shallow=False), name


def test_hf_export_loads_back_into_the_port(weights, tmp_path):
    """The exported AST safetensors load through the port's loader
    (``normalize_state`` routes the AST keys) into the same outputs."""
    pytest.importorskip("safetensors")
    _, _, net = weights
    out = hf_ast.save_pretrained(net, None, str(tmp_path / "hf"))
    state = normalize_state(load_checkpoint_file(f"{out}/model.safetensors"),
                            net.cfg, swa_weights=True)
    back = load_into(MAESTNet(net.cfg), state).eval()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 1, 96, 312)).astype("f4"))
    with torch.inference_mode():
        np.testing.assert_allclose(back(x)[0].numpy(), net(x)[0].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_save_pretrained_needs_safetensors(weights, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    with pytest.raises(ImportError, match="'safetensors' package"):
        hf_ast.save_pretrained(weights[2], None, str(tmp_path / "x"))
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("swa_prefix", [False, True])
def test_save_torch_checkpoint_equals_jax(weights, tmp_path, swa_prefix):
    """The ``.pt`` state dicts hold the same keys and values (a "mean"
    model has no ``head_dist``, as the JAX tree has none), and load back
    through ``get_maest(checkpoint=...)`` on the CPU."""
    from maest_tpu_torch import get_maest

    params, jcfg, net = weights
    ours = hf_ast.save_torch_checkpoint(net, None, str(tmp_path / "o.pt"),
                                        swa_prefix=swa_prefix)
    ref = jax_hf.save_torch_checkpoint(params, jcfg, str(tmp_path / "r.pt"),
                                       swa_prefix=swa_prefix)
    a, b = torch.load(ours), torch.load(ref)
    assert sorted(a) == sorted(b)
    assert all(k.startswith("net_swa.") == swa_prefix for k in a)
    for k in b:
        assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
    m = get_maest(pretrained=False, checkpoint=ours, device="cpu",
                  n_classes=40, input_t=312, embed_dim=64, depth=2,
                  num_heads=4)
    x = np.random.default_rng(2).standard_normal((2, 96, 312)).astype("f4")
    np.testing.assert_allclose(m(x)[0].numpy(), _jax_logits(
        params, jcfg, x.transpose(0, 2, 1)), rtol=2e-4, atol=2e-5)


def test_export_refusals(weights, tmp_path):
    """As the JAX package: a per-frequency model (export the pre-surgery
    weights), a model without qkv biases, a non-distilled one; ONNX of a
    head other than "mean"."""
    _, _, net = weights
    state, cfg = surgery.per_freq_params_from_conv(net.state_dict(), net.cfg)
    pf = load_into(MAESTNet(cfg), state)
    for fn in (hf_ast.save_torch_checkpoint, hf_ast.save_pretrained):
        with pytest.raises(NotImplementedError, match="pre-surgery"):
            fn(pf, None, str(tmp_path / "pf"))
    with pytest.raises(NotImplementedError, match="pre-surgery"):
        onnx_export.export_onnx(pf, str(tmp_path / "pf.onnx"))
    nobias = MAESTNet(net.cfg.replace(qkv_bias=False))
    with pytest.raises(NotImplementedError, match="qkv_bias"):
        hf_ast.save_pretrained(nobias, None, str(tmp_path / "nb"))
    nd = MAESTNet(net.cfg.replace(distilled=False))
    with pytest.raises(NotImplementedError, match="distilled model"):
        hf_ast.save_pretrained(nd, None, str(tmp_path / "nd"))
    with pytest.raises(NotImplementedError, match="non-distilled target"):
        hf_ast.from_hf_ast_state({}, net.cfg.replace(distilled=False))
    for bad in (net.cfg.replace(distilled_type="separated"),
                net.cfg.replace(distilled=False)):
        with pytest.raises(NotImplementedError, match="deployed head"):
            onnx_export.export_onnx(MAESTNet(bad), str(tmp_path / "h.onnx"))
    with pytest.raises(ValueError, match="cfg="):
        hf_ast.save_torch_checkpoint(net.state_dict(), None,
                                     str(tmp_path / "s.pt"))


def test_push_to_hub_with_a_stand_in_api(weights, monkeypatch):
    """``push_to_hub`` creates the repo and uploads ``save_pretrained``'s
    directory through ``huggingface_hub.HfApi``, here a stand-in that
    records the calls and the files: nothing reaches the network."""
    pytest.importorskip("safetensors")
    calls = []

    class HfApi:
        def create_repo(self, repo_id, private, exist_ok):
            calls.append(("create_repo", repo_id, private, exist_ok))

        def upload_folder(self, folder_path, repo_id):
            import os

            cfg = json.load(open(os.path.join(folder_path, "config.json")))
            calls.append(("upload_folder", repo_id,
                          sorted(os.listdir(folder_path)),
                          cfg["id2label"]["0"]))

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(HfApi=HfApi))
    assert hf_ast.push_to_hub(weights[2], None, "me/maest-tiny",
                              LABELS) == "me/maest-tiny"
    assert calls == [
        ("create_repo", "me/maest-tiny", True, True),
        ("upload_folder", "me/maest-tiny",
         ["config.json", "feature_extraction_maest.py", "model.safetensors",
          "preprocessor_config.json"], "l0")]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub"):
        hf_ast.push_to_hub(weights[2], None, "me/maest-tiny")


def test_onnx_deployed_module_matches_jax(weights):
    """The module ``export_onnx`` traces (the port's MAESTNet, fp32 on the
    CPU, materialised softmax): logits within 1e-5 of JAX's, activations
    their sigmoid, every block's tokens; the caller's model untouched."""
    params, jcfg, net = weights
    m = onnx_export.deployed_model(net)
    assert m.net is not net and m.net.cfg.attention_impl == "xla"
    x = np.random.default_rng(0).standard_normal((2, 312, 96)).astype("f4")
    with torch.no_grad():
        out = m(torch.from_numpy(x))
    np.testing.assert_allclose(out[0].numpy(), _jax_logits(params, jcfg, x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(),
                               1 / (1 + np.exp(-out[0].numpy())), rtol=1e-6)
    assert len(out) == 2 + GEOM["depth"]
    assert out[2].shape == (2, 2 + 9 * ((312 - 16) // 10 + 1), 64)
    assert net.cfg.attention_impl == "auto"


def test_onnx_file_interface(weights, tmp_path):
    """The file's interface and op set, read without the onnx package, as
    tests/test_onnx_export.py asks of the JAX package's file."""
    params, jcfg, net = weights
    path = str(tmp_path / "model.onnx")
    assert onnx_export.export_onnx(net, path) == path
    io = onnx_export.read_onnx_io(path)
    assert io["inputs"] == ["melspectrogram"]
    assert io["outputs"][:2] == ["logits", "activations"]
    assert io["outputs"][2:] == [f"layer_{i}_tokens"
                                 for i in range(GEOM["depth"])]
    assert io["opset"] == 17
    for op in ("Conv", "MatMul", "LayerNormalization", "Softmax", "Sigmoid",
               "Gemm", "Erf"):
        assert io["ops"].get(op, 0) >= 1, f"missing {op} in exported graph"
    n_params = sum(int(np.prod(np.shape(v))) for v in jax.tree.leaves(params))
    import os

    assert os.path.getsize(path) > 4 * n_params
    # the JAX package's reader reads the port's file the same way
    assert jax_onnx.read_onnx_io(path) == io


def _varint(v):
    out = b""
    while True:
        b7, v = v & 0x7F, v >> 7
        out += bytes([b7 | (0x80 if v else 0)])
        if not v:
            return out


def _field(num, wire, payload):
    tag = _varint(num << 3 | wire)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + _varint(payload)


@pytest.mark.parametrize("case", ["truncated", "no_graph", "custom_domain"])
def test_read_onnx_io_matches_jax_reader(tmp_path, case):
    """The port's copy of the protobuf reader against the JAX package's on
    a truncated file, a file without a graph and one whose custom-domain
    opset import must not shadow the default opset."""
    graph = _field(11, 2, _field(1, 2, b"in")) + _field(12, 2,
                                                         _field(1, 2, b"out"))
    data = {
        "truncated": b"\x80\x80\x80",
        "no_graph": _field(1, 0, 8),
        "custom_domain": (_field(1, 0, 8) + _field(8, 2, _field(2, 0, 17))
                          + _field(8, 2, _field(1, 2, b"com.microsoft")
                                   + _field(2, 0, 1))
                          + _field(7, 2, graph)),
    }[case]
    p = tmp_path / "f.onnx"
    p.write_bytes(data)
    if case == "custom_domain":
        io = onnx_export.read_onnx_io(str(p))
        assert io == jax_onnx.read_onnx_io(str(p))
        assert io["opset"] == 17 and io["inputs"] == ["in"]
        return
    for fn in (onnx_export.read_onnx_io, jax_onnx.read_onnx_io):
        with pytest.raises(ValueError, match="varint|ONNX"):
            fn(str(p))


def test_export_runs_end_to_end_in_transformers(weights, tmp_path):
    """The exported directory in ``transformers``: ``AutoFeatureExtractor``
    from the shipped module, ``ASTForAudioClassification`` from the
    weights, against the port's logits on the same features (5e-4, the
    bound of tests/test_hf_feature_extractor.py)."""
    pytest.importorskip("safetensors")
    transformers = pytest.importorskip("transformers")
    _, _, net = weights
    cfg = net.cfg.replace(img_size=(96, 126))
    small = load_into(MAESTNet(cfg), net.state_dict()).eval()
    out = hf_ast.save_pretrained(small, None, str(tmp_path / "hf"), LABELS)
    fx = transformers.AutoFeatureExtractor.from_pretrained(
        out, trust_remote_code=True)
    wave = np.random.default_rng(4).standard_normal(32000).astype("f4") * 0.1
    feats = fx(wave)["input_values"]
    assert feats.shape == (1, 126, 96)
    model = transformers.ASTForAudioClassification.from_pretrained(out).eval()
    with torch.no_grad():
        hf_logits = model(torch.from_numpy(feats)).logits.numpy()
        ours = small(torch.from_numpy(feats).transpose(1, 2)[:, None])[0]
    assert model.config.id2label[0] == "l0"
    np.testing.assert_allclose(ours.numpy(), hf_logits, atol=5e-4, rtol=5e-4)
