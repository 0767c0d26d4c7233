"""cmh_torch.server over real HTTP on the CPU, held against the JAX path.

A tiny cmh_tpu DCMHT model's weights cross into an encoder file of the
port; the port's server (``device="cpu"``) answers raw-code, text and
image queries, and every answer must equal cmh_tpu's: its encoder outputs
binarized by ``make_hash_code`` and searched by its ``RetrievalIndex``.
"""

import base64
import http.client
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_threads  # noqa: F401  (before any torch work)
from cmh_torch.config import config_from_dict
from cmh_torch.data.transforms import eval_transform
from cmh_torch.export import load_encoders, save_encoders
from cmh_torch.models.clip.tokenizer import SimpleTokenizer, tokenize_caption
from cmh_torch.models.convert import dcmht_state_from_jax
from cmh_torch.models.dcmht import DCMHTModel
from cmh_torch.server import RetrievalApp, make_server
from cmh_torch.serving import RetrievalIndex
from cmh_torch.utils import prng
from cmh_tpu.config import config_from_dict as jax_config_from_dict
from cmh_tpu.models.dcmht import DCMHTMethod
from cmh_tpu.serving import RetrievalIndex as JaxIndex

W, BITS = 12, 8
CFG = {"model": {"arch": "DCMHT", "clip_variant": "tiny", "hash_func": "softmax"},
       "run": {"output_dim": BITS}, "dataset": {"max_word": W}}


def _request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = json.dumps(payload) if payload is not None else None
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    method = DCMHTMethod.from_config(
        jax_config_from_dict({"model": CFG["model"]}).model, output_dim=BITS)
    rng = np.random.RandomState(17)
    res = method.clip_cfg.image_resolution
    image = rng.randn(8, res, res, 3).astype(np.float32)
    variables = method.init_variables(
        jax.random.PRNGKey(4),
        {"image": jnp.asarray(image), "text": jnp.zeros((8, W), jnp.int32),
         "key_padding_mask": jnp.zeros((8, W), bool)})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = DCMHTModel.from_config(config_from_dict(CFG))
    model.load_state_dict(dcmht_state_from_jax(variables["params"],
                                               variables["batch_stats"]))
    path = str(tmp_path_factory.mktemp("enc") / "enc.pt")
    save_encoders(model, config_from_dict(CFG), path)

    def jax_image(x):
        h = method.module.apply(variables, jnp.asarray(x), train=False,
                                method=lambda m, x, train: m.encode_image(x, train=train))
        return np.asarray(method.make_hash_code(h))

    def jax_text(ids, kpm):
        h = method.module.apply(
            variables, jnp.asarray(ids), jnp.asarray(kpm), train=False,
            method=lambda m, t, k, train: m.encode_text(t, k, train=train))
        return np.asarray(method.make_hash_code(h))

    gallery = np.concatenate([jax_image(image),
                              rng.choice([-1.0, 1.0], (92, BITS)).astype(np.float32)])
    ref_index = JaxIndex(BITS)
    ref_index.add(gallery)
    index = RetrievalIndex(BITS, device="cpu")
    index.add(gallery)
    return path, index, ref_index, jax_image, jax_text, res, rng


def test_loaded_encoders_equal_jax_codes(setup):
    path, _, _, jax_image, jax_text, res, rng = setup
    enc = load_encoders(path, device="cpu")
    img = rng.randn(3, res, res, 3).astype(np.float32)
    np.testing.assert_array_equal(enc.encode_image(img), jax_image(img))
    tok = SimpleTokenizer()
    ids, masks = zip(*(tokenize_caption(tok, c, W) for c in ("a cat", "two dogs")))
    np.testing.assert_array_equal(enc.encode_text(np.stack(ids), np.stack(masks)),
                                  jax_text(np.stack(ids), np.stack(masks)))


def test_http_server_end_to_end_matches_jax(setup):
    path, index, ref_index, jax_image, jax_text, res, rng = setup
    tok = SimpleTokenizer()
    app = RetrievalApp(index, load_encoders(path, device="cpu"), tok,
                       max_words=W, image_size=res)
    server = make_server(app, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, health = _request(port, "GET", "/healthz")
        assert status == 200
        assert health == {"count": 100, "bits": BITS, "device": "cpu", "backend": "device",
                          "text": True}

        queries = rng.choice([-1.0, 1.0], size=(3, BITS)).astype(np.float32)
        status, out = _request(port, "POST", "/search",
                               {"codes": queries.tolist(), "topk": 4})
        assert status == 200
        want_d, want_i = ref_index.search_cpu(queries, topk=4)
        assert (out["dist"], out["idx"]) == (want_d.tolist(), want_i.tolist())

        captions = ["a dog on the grass", "two people riding bikes"]
        status, out = _request(port, "POST", "/search_text",
                               {"text": captions, "topk": 5})
        assert status == 200
        ids, masks = zip(*(tokenize_caption(tok, c, W) for c in captions))
        want_d, want_i = ref_index.search_cpu(
            jax_text(np.stack(ids), np.stack(masks)), topk=5)
        assert (out["dist"], out["idx"]) == (want_d.tolist(), want_i.tolist())

        from PIL import Image

        raws = [Image.fromarray(rng.randint(0, 255, (40, 52, 3), dtype=np.uint8))
                for _ in range(2)]
        blobs = []
        for im in raws:
            buf = io.BytesIO()
            im.save(buf, format="PNG")
            blobs.append(base64.b64encode(buf.getvalue()).decode())
        status, out = _request(port, "POST", "/search_image",
                               {"image_b64": blobs, "topk": 3})
        assert status == 200
        pix = np.stack([eval_transform(im, res) for im in raws])
        want_d, want_i = ref_index.search_cpu(jax_image(pix), topk=3)
        assert (out["dist"], out["idx"]) == (want_d.tolist(), want_i.tolist())

        # error paths: named 400s and 404s, server stays up
        status, out = _request(port, "POST", "/search",
                               {"codes": queries.tolist(), "topk": 999})
        assert status == 400 and "topk" in out["error"]
        status, _ = _request(port, "POST", "/search", {"codes": [[1.0, -1.0]]})
        assert status == 400
        status, _ = _request(port, "POST", "/nonsense", {})
        assert status == 404
        status, out = _request(port, "POST", "/search", {})
        assert status == 400 and "codes" in out["error"]
        status, out = _request(port, "POST", "/search_image", {"image_b64": ["aGVsbG8="]})
        assert status == 400 and "image_b64[0]" in out["error"]
        status, _ = _request(port, "GET", "/healthz")
        assert status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_server_without_encoders_rejects_text(setup):
    _, index, _, _, _, _, _ = setup
    app = RetrievalApp(index)
    assert app.healthz()["text"] is False
    with pytest.raises(ValueError, match="search_text"):
        app.search_text({"text": ["hi"]})


def _dsph_trainer(tmp_path):
    from cmh_torch.runners.dsph import DSPHTrainer

    cfg = {"model": {"arch": "DSPH", "clip_path": "/nonexistent.pt", "clip_variant": "tiny",
                     "numclass": 4},
           "optimizer": {"arch": "BertAdam", "lr": 0.002, "hyp": {"lr": 0.02}},
           "dataset": {"arch": "synthetic_dataset", "name": "synthetic", "num_classes": 4,
                       "image_resolution": 32, "max_word": W},
           "run": {"arch": "DSPHTrainer", "save_dir": str(tmp_path),
                   "log_dir": str(tmp_path / "log"), "output_dim": BITS, "batch_size": 16,
                   "train_num": 32, "query_num": 16, "epochs": 1, "display_step": 1000}}
    tr = DSPHTrainer.from_config(cfg=config_from_dict(cfg), device="cpu", auto_run=False)
    tr.train()
    return tr


def test_dsph_encoders_give_the_trainers_eval_codes_and_search(tmp_path):
    """A trained DSPH model exported and reloaded: its codes equal the
    trainer's eval codes, and a search of its retrieval codes through the
    port's index equals cmh_tpu's index on the same codes."""
    tr = _dsph_trainer(tmp_path)
    path = str(tmp_path / "dsph_enc.pt")
    save_encoders(tr.model, tr.cfg, path)
    enc = load_encoders(path, device="cpu")
    assert type(enc.model).__name__ == "DSPHModel" and enc.method.arch == "DSPH"
    q_img, q_txt = (c.numpy() for c in tr.get_code(tr.query_loader, tr.query_num))
    r_img, r_txt = (c.numpy() for c in tr.get_code(tr.retrieval_loader, tr.retrieval_num))
    got_img, got_txt = np.zeros_like(q_img), np.zeros_like(q_txt)
    for batch in tr.query_loader:
        idx = batch["index"][batch["valid"]]
        got_img[idx] = enc.encode_image(batch["image"])[batch["valid"]]
        got_txt[idx] = enc.encode_text(batch["text"], batch["key_padding_mask"])[batch["valid"]]
    np.testing.assert_array_equal(got_img, q_img)
    np.testing.assert_array_equal(got_txt, q_txt)
    index, ref = RetrievalIndex(BITS, device="cpu"), JaxIndex(BITS)
    index.add(r_img)
    ref.add(r_img)
    dist, idx = index.search(got_txt, topk=10)
    want_d, want_i = ref.search(got_txt, topk=10)
    np.testing.assert_array_equal(np.asarray(dist), np.asarray(want_d))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(want_i))


def test_export_cli_fills_the_backbone_from_clip_path(tmp_path):
    """``python -m cmh_torch.export --clip-path``: the encoder file's
    backbone is the checkpoint's, its DSPH head the seeded init."""
    import torch

    from cmh_torch.export import main as export_main
    from cmh_torch.models.clip.loader import save_torchscript_archive
    from cmh_torch.models.clip.model import CLIP, CLIPConfig

    clip = CLIP(CLIPConfig.tiny())
    clip.init_weights(prng.PRNGKey(21))
    ckpt = str(tmp_path / "clip.pt")
    save_torchscript_archive({k: v.half() for k, v in clip.state_dict().items()}, ckpt)
    cfg = tmp_path / "dsph.yaml"
    cfg.write_text("model: {arch: DSPH, numclass: 4, clip_variant: tiny}\nrun: {output_dim: 8}\n")
    outs = {}
    for name, extra in (("loaded", ["--clip-path", ckpt]), ("random", [])):
        out = str(tmp_path / f"{name}.pt")
        export_main(["--config-file", str(cfg), "--out", out, "--seed", "2",
                     "--device", "cpu"] + extra)
        outs[name] = load_encoders(out, device="cpu").model.state_dict()
    for k, v in clip.state_dict().items():
        assert torch.equal(outs["loaded"]["backbone." + k], v.half().float()), k
    for k, v in outs["loaded"].items():
        if not k.startswith("backbone."):
            assert torch.equal(v, outs["random"][k]), k
