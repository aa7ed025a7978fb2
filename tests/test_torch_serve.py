"""Serving stack of the PyTorch port on the CPU: bucket programs, dynamic
cross-request batching, the pcm16 and fused-wave programs and the HTTP
front. Served activations must equal the port's own ``predict_labels``
(rtol 1e-5, atol 1e-6: the same fp32 math, batched differently).

The mesh: ``MAEST`` over gloo ranks on the CPU (dp 2, tp 2 in one spawn of
2 processes, dp 2 x tp 2 in one of 4) against the JAX package's
single-device ``MAEST`` on the same checkpoint within 1e-4 (a wave of 3
chunks, padded to 4 rows over 2 data ranks; a rank-3 mel batch; a block
tap), and a mesh ``TagService`` at dp 2 against one process's
``predict_labels``. ``host_mel`` against the JAX package's
``TagService(host_mel=True)`` within 1e-5."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from maest_tpu.api import get_maest as jax_get_maest
from maest_tpu.models.registry import build_config
from maest_tpu.serve import TagService as JaxTagService
from maest_tpu_torch.api import get_maest
from maest_tpu_torch.apps.serve import build_argparser, make_service, serve_forever
from maest_tpu_torch.serve import (
    BucketPrograms,
    DynamicBatcher,
    TagService,
    pick_bucket,
)

from torch_oracle import make_state

import torch_parallel_worker as W

SR = 16000
TOL = dict(rtol=1e-5, atol=1e-6)
GEOM = dict(embed_dim=64, depth=2, num_heads=4, input_t=62, n_classes=16)
ARCH = "discogs-maest-30s-pw-129e"
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    m = get_maest("discogs-maest-30s-pw-129e", pretrained=False, device="cpu",
                  embed_dim=64, depth=2, num_heads=4, input_t=62, n_classes=16)
    # heads start at zero (every activation 0.5): perturb so ranks differ
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        m.net.head[1].weight.normal_(0.0, 0.1, generator=gen)
    return m


def _wave(seconds, seed=0):
    return np.random.default_rng(seed).standard_normal(
        int(seconds * SR)).astype(np.float32)


def _pcm(n, seed):
    return (np.clip(np.random.default_rng(seed).standard_normal(n) * 0.3,
                    -1, 1) * 32767).astype(np.int16)


def test_pick_bucket():
    assert [pick_bucket(n, (1, 2, 4)) for n in (1, 3, 4, 9)] == [1, 4, 4, 4]


def test_bucket_padding_matches_direct(model):
    progs = BucketPrograms(model, buckets=(1, 4, 8))
    chunks = np.random.default_rng(1).standard_normal(
        (3, 96, 62)).astype(np.float32)
    direct = torch.sigmoid(model(chunks[:, None])[0]).numpy()
    np.testing.assert_allclose(progs.run(chunks), direct, **TOL)
    with pytest.raises(ValueError, match="max bucket"):
        progs.run(np.zeros((9, 96, 62), np.float32))


def test_concurrent_mixed_requests(model):
    """Threads send native-length float, native-length pcm16, multi-chunk
    odd-length and short clips at once; each gets its own answer."""
    svc = TagService(model, buckets=(1, 2, 4, 8), max_wait_ms=20.0)
    try:
        native = svc.wave_programs.native_len
        assert native == 62 * 256
        reqs = [_wave(native / SR, seed=s) for s in range(4)]
        reqs += [_pcm(native, seed=s) for s in (10, 11)]
        reqs += [_wave(3.3, seed=20), _wave(1.7, seed=21), _wave(0.5, seed=22)]
        refs = [model.predict_labels(r)[0] for r in reqs]
        outs = [None] * len(reqs)

        def worker(i):
            outs[i] = svc.tag(reqs[i])[0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for got, ref in zip(outs, refs):
            np.testing.assert_allclose(got, ref, **TOL)
        st = svc.stats()
        assert st["requests"] == len(reqs)
        assert st["chunks"] == 4 + 2 + 3 + 1 + 1
        assert st["batches"] < len(reqs)  # requests shared device batches
        with pytest.raises(ValueError, match="native length"):
            svc.tag(_pcm(100, seed=1))
    finally:
        svc.close()


def test_service_serves_an_8bit_attention_model():
    """A model built with attention_quant serves as its own predict_labels
    does: the 8-bit scales are per row, per key and per sample, so batching
    other requests beside a clip changes none of its numbers."""
    m = get_maest("discogs-maest-30s-pw-129e", pretrained=False, device="cpu",
                  embed_dim=64, depth=2, num_heads=1, input_t=62, n_classes=16,
                  attention_quant="qk8pv8")
    assert all(b.attn.quant == "qk8pv8" for b in m.net.blocks)
    with torch.no_grad():
        m.net.head[1].weight.normal_(0.0, 0.1,
                                     generator=torch.Generator().manual_seed(8))
    svc = TagService(m, buckets=(1, 2, 4), max_wait_ms=20.0)
    try:
        reqs = [_wave(1.0, seed=s) for s in range(3)] + [_wave(2.5, seed=9)]
        outs = [None] * len(reqs)

        def worker(i):
            outs[i] = svc.tag(reqs[i])[0]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for got, r in zip(outs, reqs):
            np.testing.assert_allclose(got, m.predict_labels(r)[0], **TOL)
    finally:
        svc.close()


def test_oversized_request_splits_and_empty_resolves(model):
    svc = TagService(model, buckets=(1, 2), max_wait_ms=0.0)
    try:
        wave = _wave(5.2, seed=3)  # 5 chunks > max bucket 2
        np.testing.assert_allclose(svc.tag(wave)[0],
                                   model.predict_labels(wave)[0], **TOL)
        assert svc.stats()["batches"] >= 3
        out = svc.batcher.submit(np.empty((0, 96, 62), np.float32)).result(5)
        assert out.shape == (0, 16)
        with pytest.raises(ValueError, match="at least one"):
            svc.tag_mel_chunks(np.empty((0, 96, 62), np.float32))
    finally:
        svc.close()


def test_batcher_resolves_every_future_after_cancel(model):
    programs = BucketPrograms(model, buckets=(1, 2))
    batcher = DynamicBatcher(programs, max_wait_ms=0.0)
    try:
        chunk = np.zeros((1, 96, 62), np.float32)
        batcher.submit(chunk).cancel()
        assert batcher.submit(chunk).result(timeout=60).shape == (1, 16)
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.submit(np.zeros((1, 96, 62), np.float32))


def test_cli_builds_service():
    """The server's command line builds the model and a warmed-up service
    on the device and dtype it names."""
    args = build_argparser().parse_args([
        "--no-pretrained", "--device", "cpu", "--dtype", "float32",
        "--embed-dim", "64", "--depth", "1", "--num-heads", "4",
        "--input-t", "62", "--n-classes", "16", "--buckets", "1,2"])
    svc = make_service(args)
    try:
        assert svc.model.device.type == "cpu"
        assert svc.model.dtype == torch.float32
        assert svc.wave_programs.buckets == (1, 2)
        wave = _wave(2.1, seed=4)
        np.testing.assert_allclose(svc.tag(wave)[0],
                                   svc.model.predict_labels(wave)[0], **TOL)
    finally:
        svc.close()


def test_http_front(model):
    svc = TagService(model, buckets=(1, 2, 4), max_wait_ms=5.0)
    server, _ = serve_forever(svc, "127.0.0.1", 0, top_k=16)
    url = f"http://127.0.0.1:{server.server_port}"

    def post(data, ctype):
        req = urllib.request.Request(f"{url}/tag", data=data,
                                     headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        native = svc.wave_programs.native_len
        wave, odd, pcm = _wave(native / SR, 1), _wave(2.9, 2), _pcm(native, 3)
        cases = [
            (wave.tobytes(), "application/octet-stream", wave),
            (odd.tobytes(), "application/octet-stream", odd),
            (pcm.astype(">i2").tobytes(), "audio/l16", pcm),
            (pcm.astype("<i2").tobytes(), "audio/pcm", pcm),
            (json.dumps({"waveform": odd[:SR].tolist()}).encode(),
             "application/json", odd[:SR]),
        ]
        outs = [None] * len(cases)

        def worker(i):
            outs[i] = post(*cases[i][:2])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for res, (_, _, x) in zip(outs, cases):
            ref, labels = model.predict_labels(x)
            assert labels is None  # a 16-class head has no vocabulary
            got = {int(name): score for name, score in res["labels"]}
            assert len(got) == 16
            np.testing.assert_allclose([got[i] for i in range(16)], ref, **TOL)
        with urllib.request.urlopen(f"{url}/stats", timeout=30) as r:
            assert json.loads(r.read())["requests"] == len(cases)
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nope", timeout=30)
        with pytest.raises(urllib.error.HTTPError) as err:
            post(b"", "application/octet-stream")
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg = build_config(ARCH, **GEOM)
    state = make_state(np.random.default_rng(21), cfg, scale=0.1)
    path = tmp_path_factory.mktemp("mesh") / "tiny.pt"
    torch.save(state, path)
    return str(path)


def _mesh_inputs():
    native = 62 * 256
    reqs = [_wave(native / SR, seed=30), _pcm(native, seed=31),
            _wave(3.3, seed=32), _wave(0.5, seed=33)]
    return {"wave": _wave(3 * native / SR + 0.1, seed=34),
            "mel3": np.random.default_rng(35).standard_normal(
                (3, 96, 62)).astype(np.float32),
            "requests": reqs}


@pytest.fixture(scope="module")
def jax_ref(ckpt):
    m = jax_get_maest(ARCH, pretrained=False, checkpoint=ckpt, **GEOM)
    x = _mesh_inputs()
    return {"wave": [np.asarray(t) for t in m(x["wave"])],
            "mel3": [np.asarray(t) for t in m(x["mel3"])],
            "tap": np.asarray(m(x["wave"], transformer_block=1)[1]),
            "acts": m.predict_labels(x["wave"])[0]}


@pytest.fixture(scope="module")
def mesh2(ckpt):
    """One spawn of 2 gloo ranks: dp 2 and tp 2, the mesh service, the
    server's command line."""
    from maest_tpu_torch.parallel.launch import spawn

    return spawn(W.mesh_inference, 2, ckpt, GEOM, _mesh_inputs(), (1, 2),
                 True, timeout=300)


def _held_to_jax(got, ref):
    assert got["wave"][0].shape == (3, 16)  # 3 chunks, the 4th row cut
    for k in ("wave", "mel3"):
        for a, b in zip(got[k], ref[k]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=JAX_ATOL)
    np.testing.assert_allclose(got["tap"], ref["tap"], atol=JAX_ATOL)
    np.testing.assert_allclose(got["acts"], ref["acts"], atol=JAX_ATOL)


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["dp2", "tp2"])
def test_mesh_maest_matches_jax(mesh2, jax_ref, model_parallel):
    for rank in mesh2:  # every rank returns the whole result
        _held_to_jax(rank[model_parallel], jax_ref)
    # tp 2: each rank holds 2 of the 4 heads' qkv rows
    assert mesh2[0][model_parallel]["heads"] == 3 * 64 // model_parallel


def test_mesh_dp_tp_4_matches_jax(ckpt, jax_ref):
    from maest_tpu_torch.parallel.launch import spawn

    ranks = spawn(W.mesh_inference, 4, ckpt, GEOM, _mesh_inputs(), (2,),
                  False, timeout=300)
    for rank in ranks:
        _held_to_jax(rank[2], jax_ref)


def test_mesh_service_matches_predict_labels(mesh2, ckpt):
    """Rank 0 serves 4 concurrent requests (native float, native pcm16, 3
    chunks, a short clip) at dp 2; rank 1 follows every batch."""
    one = get_maest(ARCH, pretrained=False, checkpoint=ckpt, device="cpu",
                    **GEOM)
    reqs = _mesh_inputs()["requests"]
    lead, follower = mesh2
    assert lead["buckets"] == (2, 4)  # rounded up to the data ranks
    assert follower["followed"] >= 3 and "served" not in follower
    assert lead["stats"]["requests"] == len(reqs)
    for got, r in zip(lead["served"], reqs):
        np.testing.assert_allclose(got, one.predict_labels(r)[0], **TOL)
    # the command line: --host-mel --devices 2, the short clip
    assert follower["cli_followed"] >= 1
    np.testing.assert_allclose(lead["cli"], one.predict_labels(reqs[-1])[0],
                               atol=1e-5)


def test_host_mel_matches_jax(ckpt):
    """host_mel: the numpy front-end (the JAX package's arithmetic) for
    clips of other than native length, a long one and a short one."""
    ours = get_maest(ARCH, pretrained=False, checkpoint=ckpt, device="cpu",
                     **GEOM)
    ref = jax_get_maest(ARCH, pretrained=False, checkpoint=ckpt, **GEOM)
    svc = TagService(ours, buckets=(1, 2, 4), host_mel=True)
    jsvc = JaxTagService(ref, buckets=(1, 2, 4), host_mel=True)
    try:
        for w in (_wave(3.3, seed=40), _wave(0.5, seed=41)):
            got = svc.tag(w)[0]
            np.testing.assert_allclose(got, jsvc.tag(w)[0], atol=1e-5)
            np.testing.assert_allclose(got, ours.predict_labels(w)[0],
                                       atol=1e-5)
    finally:
        svc.close()
        jsvc.close()


def test_stats_reset_window_clears_only_latency(model):
    svc = TagService(model, buckets=(1, 2), max_wait_ms=0.0)
    try:
        svc.tag(_wave(62 * 256 / SR, seed=42))
        svc.tag(_wave(2.3, seed=43))
        before = svc.stats()
        assert before["latency_ms_p50"] > 0
        svc.stats_reset_window()
        after = svc.stats()
        assert after["latency_ms_p50"] == after["latency_ms_p99"] == 0.0
        assert {k: v for k, v in after.items() if "latency" not in k} == {
            k: v for k, v in before.items() if "latency" not in k}
        assert after["requests"] == 2
    finally:
        svc.close()


def test_cli_host_mel_and_devices_parse():
    args = build_argparser().parse_args(["--host-mel", "--devices", "2"])
    assert args.host_mel and args.devices == 2
    args = build_argparser().parse_args([])
    assert not args.host_mel and args.devices is None
    args = build_argparser().parse_args([
        "--no-pretrained", "--device", "cpu", "--dtype", "float32",
        "--embed-dim", "64", "--depth", "1", "--num-heads", "4",
        "--input-t", "62", "--n-classes", "16", "--buckets", "1,2",
        "--host-mel", "--devices", "1", "--no-warmup"])
    svc = make_service(args)
    try:
        assert svc.host_mel and svc.model.mesh is None and not svc.follower
        wave = _wave(2.1, seed=44)
        np.testing.assert_allclose(svc.tag(wave)[0],
                                   svc.model.predict_labels(wave)[0],
                                   atol=1e-5)
    finally:
        svc.close()
