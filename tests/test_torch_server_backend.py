"""The port's server backends and a TwDH encoder file behind it, on the CPU.

``--backend cpu`` answers through ``RetrievalIndex.search_cpu`` (the host
C++ scorer), ``--backend device`` (the default) through
``RetrievalIndex.search``; over HTTP, on one ``.npz`` index, both give the
same answers, equal to cmh_tpu's ``RetrievalApp(backend="cpu")`` on the
same file. ``/healthz`` names the backend and the device. With ``--device
cpu --backend cpu`` nothing builds or loads a CUDA library, and a failed
g++ build raises rather than falling back to the plain scorer. A TwDH
encoder file's encoders give (long codes, {width: codes}); ``/search_text``
and ``/search_image`` search the long codes and equal ``index.search`` on
them.
"""

import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest

import torch_threads  # noqa: F401  (before any torch work)
import cmh_torch.native._build as native_build
import cmh_torch.ops._build as cuda_build
import cmh_torch.server as port_server
from cmh_torch.config import config_from_dict
from cmh_torch.data.transforms import eval_transform
from cmh_torch.export import load_encoders, save_encoders
from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
from cmh_torch.registry import load_components
from cmh_torch.server import RetrievalApp, make_server
from cmh_torch.serving import RetrievalIndex
from cmh_torch.utils import prng
from cmh_tpu.server import RetrievalApp as JaxApp
from cmh_tpu.serving import RetrievalIndex as JaxIndex

BITS, ITEMS, W = 64, 500, 12
TWDH = {"arch": "TwDH", "clip_variant": "tiny", "long_dim": 64, "short_dims": [8],
        "numclass": 4, "hash_func": "softmax", "long_center": "/nonexistent",
        "short_center": "/nonexistent", "trans_matrix": "/nonexistent"}


def _request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=json.dumps(payload) if payload is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class Serving:
    """``make_server`` on a free local port in a thread, closed on exit."""

    def __init__(self, app):
        self.server = make_server(app, port=0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """A 64-bit index of ITEMS random codes with repeated rows (distance
    ties), saved in the shared npz layout, and queries."""
    rng = np.random.RandomState(0)
    codes = rng.choice([-1.0, 1.0], size=(ITEMS, BITS)).astype(np.float32)
    codes[10:20] = codes[0]
    path = str(tmp_path_factory.mktemp("index") / "gallery.npz")
    index = RetrievalIndex(BITS, device="cpu")
    index.add(codes)
    index.save(path)
    queries = np.concatenate([codes[:2], rng.choice([-1.0, 1.0], size=(3, BITS))]).astype(
        np.float32)
    return path, queries


def test_backends_agree_with_each_other_and_cmh_tpu(gallery):
    path, queries = gallery
    jax_app = JaxApp(JaxIndex.load(path), backend="cpu")
    payload = {"codes": queries.tolist(), "topk": 25}
    want = jax_app.search(payload)
    answers = {}
    for backend in ("device", "cpu"):
        app = RetrievalApp(RetrievalIndex.load(path, device="cpu"), backend=backend)
        with Serving(app) as s:
            status, health = _request(s.port, "GET", "/healthz")
            assert status == 200
            assert health == {"count": ITEMS, "bits": BITS, "device": "cpu",
                              "backend": backend, "text": False}
            status, answers[backend] = _request(s.port, "POST", "/search", payload)
            assert status == 200
            status, out = _request(s.port, "POST", "/search", dict(payload, topk=ITEMS + 1))
            assert status == 400 and "topk" in out["error"]
    assert answers["device"] == answers["cpu"] == want
    assert answers["cpu"]["idx"][0][:11] == [0] + list(range(10, 20))   # ties by index
    with pytest.raises(ValueError, match="backend"):
        RetrievalApp(RetrievalIndex.load(path, device="cpu"), backend="tpu")


def test_cpu_backend_on_the_cpu_builds_no_cuda_library(gallery, tmp_path, monkeypatch):
    """``python -m cmh_torch.server --device cpu --backend cpu`` serves text
    and codes with every CUDA build entry point made to fail."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA library was asked for")

    for name in ("build_all", "load", "lib_path"):
        monkeypatch.setattr(cuda_build, name, refuse)
    method = load_components().require_model_class("DCMHT").from_config(
        {"clip_variant": "tiny", "hash_func": "softmax"}, output_dim=BITS)
    method.model.init_weights(prng.PRNGKey(0))
    enc = str(tmp_path / "enc.pt")
    save_encoders(method.model, config_from_dict(
        {"model": {"arch": "DCMHT", "clip_variant": "tiny", "hash_func": "softmax"},
         "run": {"output_dim": BITS}}), enc)
    apps = []

    class NoServe:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(port_server, "make_server", lambda app, *a: apps.append(app) or NoServe())
    path, queries = gallery
    port_server.main(["--index", path, "--encoders", enc, "--device", "cpu", "--backend", "cpu",
                      "--max-words", str(W)])
    (app,) = apps
    assert app.healthz()["backend"] == "cpu"
    out = app.search_text({"text": ["a dog on the grass"], "topk": 5})
    tok = SimpleTokenizer()
    ids, mask = tokenize_caption(tok, "a dog on the grass", W)
    codes = load_encoders(enc, device="cpu").encode_text(ids[None], mask[None])
    d, i = RetrievalIndex.load(path, device="cpu").search(codes, topk=5)
    assert out == {"dist": d.tolist(), "idx": i.tolist()}
    assert app.search({"codes": queries.tolist(), "topk": 3})["idx"][0][0] == 0


def test_a_failed_host_build_raises(gallery, monkeypatch):
    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cpp")

    monkeypatch.setattr(native_build, "_loaded", {})
    monkeypatch.setattr(native_build, "build", broken)
    path, queries = gallery
    app = RetrievalApp(RetrievalIndex.load(path, device="cpu"), backend="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        app.search({"codes": queries.tolist(), "topk": 3})


def test_twdh_encoders_search_their_long_codes(tmp_path):
    method = load_components().require_model_class("TwDH").from_config(
        config_from_dict({"model": TWDH}).model, output_dim=8)
    method.model.init_weights(prng.PRNGKey(1))
    path = str(tmp_path / "twdh.pt")
    save_encoders(method.model, config_from_dict({"model": TWDH, "run": {"output_dim": 8}}),
                  path, method.eval_method_state())
    enc = load_encoders(path, device="cpu")
    res = method.model.backbone.cfg.image_resolution
    rng = np.random.RandomState(2)
    long_codes, shorts = enc.encode_image(rng.randn(40, res, res, 3).astype(np.float32))
    assert long_codes.shape == (40, 64) and sorted(shorts) == ["8"]
    index = RetrievalIndex(64, device="cpu")
    index.add(long_codes)
    index.add(rng.choice([-1.0, 1.0], size=(200, 64)).astype(np.float32))
    tok = SimpleTokenizer()
    captions = ["a red bus", "two cats on a sofa"]
    ids, masks = (np.stack(a) for a in zip(*(tokenize_caption(tok, c, W) for c in captions)))
    from PIL import Image

    raws = [Image.fromarray(rng.randint(0, 255, (40, 52, 3), dtype=np.uint8)) for _ in range(2)]
    blobs = []
    for im in raws:
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        blobs.append(base64.b64encode(buf.getvalue()).decode())
    pix = np.stack([eval_transform(im, res) for im in raws])
    for backend in ("device", "cpu"):
        app = RetrievalApp(index, enc, tok, backend=backend, max_words=W, image_size=res)
        with Serving(app) as s:
            status, out = _request(s.port, "POST", "/search_text", {"text": captions, "topk": 7})
            assert status == 200
            d, i = index.search(enc.encode_text(ids, masks)[0], topk=7)
            assert out == {"dist": d.tolist(), "idx": i.tolist()}
            status, out = _request(s.port, "POST", "/search_image", {"image_b64": blobs,
                                                                     "topk": 4})
            assert status == 200
            d, i = index.search(enc.encode_image(pix)[0], topk=4)
            assert out == {"dist": d.tolist(), "idx": i.tolist()}
