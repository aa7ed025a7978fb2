"""Serving stack of the PyTorch port on the CPU: bucket programs, dynamic
cross-request batching, the pcm16 and fused-wave programs and the HTTP
front. Served activations must equal the port's own ``predict_labels``
(rtol 1e-5, atol 1e-6: the same fp32 math, batched differently)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from maest_tpu_torch.api import get_maest
from maest_tpu_torch.apps.serve import build_argparser, make_service, serve_forever
from maest_tpu_torch.serve import (
    BucketPrograms,
    DynamicBatcher,
    TagService,
    pick_bucket,
)

SR = 16000
TOL = dict(rtol=1e-5, atol=1e-6)


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
