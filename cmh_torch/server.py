"""HTTP retrieval serving: encoders + packed index behind one port.

Counterpart of ``cmh_tpu/server.py`` with the same endpoints and JSON:

    python -m cmh_torch.server --index gallery.npz --encoders enc.pt \
        --port 8080 [--device cuda|cpu] [--backend device|cpu] [--max-words 32] [--topk 10]

- ``GET /healthz`` → ``{"count": N, "bits": K, "device": ..., "backend": ...,
  "text": bool}``
- ``POST /search`` with ``{"codes": [[±1, ...], ...], "topk": k}``
- ``POST /search_text`` with ``{"text": ["a dog on grass", ...], "topk": k}``:
  BPE tokenize → text tower + hash head → exact top-k.
- ``POST /search_image`` with ``{"image_b64": [<base64 PNG/JPEG>, ...],
  "topk": k}``: decode → eval transform → image tower + hash head → top-k.

Responses: ``{"dist": [[...]], "idx": [[...]]}`` in ascending-distance
order, ties by gallery insertion order. ``--device`` (default ``cuda``)
places the index and the encoders; without a card the server refuses to
start unless ``--device cpu`` is given. ``--backend`` picks the scorer:
``device`` (the default, unlike cmh_tpu's ``cpu``) answers through
``RetrievalIndex.search`` (kernel K4 on a CUDA index, the plain version on
a CPU one), ``cpu`` through ``search_cpu``, the host C++ scorer (built with
g++ at first use; a failed build raises, nothing falls back).

A TwDH encoder file's encoders give the tree (long codes, {width: codes});
the app searches the long codes, which are what a TwDH index holds
(cmh_tpu's server raises on the tree).
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _require(cond: bool, msg: str) -> None:
    """Request validation that survives ``python -O``; ValueError maps to
    HTTP 400 in the handler."""
    if not cond:
        raise ValueError(msg)


class RetrievalApp:
    """Request logic, HTTP-free (unit-testable without sockets)."""

    def __init__(self, index, encoders=None, tokenizer=None, backend: str = "device",
                 max_words: int = 32, image_size: int = 224,
                 default_topk: int = 10):
        if backend not in ("device", "cpu"):
            raise ValueError(f"backend must be 'device' or 'cpu', got {backend!r}")
        self.backend = backend
        self.index = index
        self.encoders = encoders
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.image_size = image_size
        self.default_topk = default_topk

    def _search(self, codes: np.ndarray, topk: int):
        _require(0 < topk <= len(self.index),
                 f"topk={topk} outside (0, {len(self.index)}]")
        search = self.index.search_cpu if self.backend == "cpu" else self.index.search
        dist, idx = search(codes, topk=topk)
        return {"dist": np.asarray(dist).tolist(),
                "idx": np.asarray(idx).tolist()}

    def healthz(self) -> dict:
        return {"count": len(self.index), "bits": self.index.bits,
                "device": self.index.device.type, "backend": self.backend,
                "text": self.encoders is not None}

    def search(self, payload: dict) -> dict:
        codes = np.asarray(payload["codes"], np.float32)
        _require(codes.ndim == 2 and codes.shape[1] == self.index.bits,
                 f"codes must be (Q, {self.index.bits})")
        return self._search(codes, int(payload.get("topk", self.default_topk)))

    def search_text(self, payload: dict) -> dict:
        _require(self.encoders is not None,
                 "server started without --encoders; /search_text unavailable")
        from .models.clip.tokenizer import tokenize_caption

        texts = payload["text"]
        _require(isinstance(texts, list) and bool(texts),
                 "text must be a non-empty list")
        ids, masks = zip(*(tokenize_caption(self.tokenizer, str(t), self.max_words)
                           for t in texts))
        codes = self.encoders.encode_text(np.stack(ids), np.stack(masks))
        return self._search(_indexed_codes(codes), int(payload.get("topk", self.default_topk)))

    def search_image(self, payload: dict) -> dict:
        _require(self.encoders is not None,
                 "server started without --encoders; /search_image unavailable")
        import base64
        import io

        from PIL import Image

        from .data.transforms import eval_transform

        blobs = payload["image_b64"]
        _require(isinstance(blobs, list) and bool(blobs),
                 "image_b64 must be a non-empty list")

        def decode(i, b):
            try:
                return Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB")
            except OSError as e:
                # PIL.UnidentifiedImageError subclasses OSError: a 400, not
                # a dropped connection
                raise ValueError(f"image_b64[{i}] is not a decodable image: {e}")

        imgs = np.stack([eval_transform(decode(i, b), self.image_size)
                         for i, b in enumerate(blobs)])
        codes = self.encoders.encode_image(imgs)
        return self._search(_indexed_codes(codes), int(payload.get("topk", self.default_topk)))

    ROUTES = {"/search": "search", "/search_text": "search_text",
              "/search_image": "search_image"}

    def handle_post(self, path: str, payload: dict) -> dict:
        method = self.ROUTES.get(path)
        if method is None:
            raise KeyError(path)
        return getattr(self, method)(payload)


def _indexed_codes(codes):
    """The codes an index holds: TwDH's long codes out of its (long,
    {width: codes}) tree, any other method's codes as they are."""
    return codes[0] if isinstance(codes, tuple) else codes


def make_server(app: RetrievalApp, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; the caller owns logging
            pass

        def _reply(self, code: int, body: dict) -> None:
            raw = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, app.healthz())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path not in RetrievalApp.ROUTES:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, app.handle_post(self.path, payload))
            except KeyError as e:
                # a missing payload field, NOT an unknown route
                self._reply(400, {"error": f"missing field {e}"})
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[list] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="serve a packed-code retrieval index over HTTP")
    ap.add_argument("--index", required=True,
                    help="RetrievalIndex .npz (RetrievalIndex.save, either package)")
    ap.add_argument("--encoders", default=None,
                    help="encoder file from cmh_torch.export (enables "
                         "/search_text and /search_image)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the index and the encoders live")
    ap.add_argument("--backend", choices=("device", "cpu"), default="device",
                    help="scorer: the index's device (K4 on the card) or the host C++ "
                         "scorer (search_cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-words", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224,
                    help="eval-transform target resolution (CLIP input)")
    ap.add_argument("--topk", type=int, default=10)
    args = ap.parse_args(argv)

    from .serving import RetrievalIndex

    index = RetrievalIndex.load(args.index, device=args.device)
    encoders = tokenizer = None
    if args.encoders:
        from .export import load_encoders
        from .models.clip.tokenizer import SimpleTokenizer

        encoders = load_encoders(args.encoders, device=args.device)
        tokenizer = SimpleTokenizer()
    app = RetrievalApp(index, encoders, tokenizer, backend=args.backend,
                       max_words=args.max_words,
                       image_size=args.image_size, default_topk=args.topk)
    server = make_server(app, args.host, args.port)
    print(f"serving {len(index)} items ({index.bits}-bit) on "
          f"http://{args.host}:{server.server_address[1]} "
          f"(text={'on' if encoders else 'off'}, device={args.device}, "
          f"backend={args.backend})",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
