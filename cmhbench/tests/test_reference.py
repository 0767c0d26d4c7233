"""The plain reference against the port, at the port's tiny CLIP in
float32 on the CPU: codes, three training steps, mAP, top-k."""

import tempfile

import torch

from cmhbench import weights
from cmhbench.kinds import search, train
from cmhbench.reference import dcmht as reference
from cmhbench.reference import retrieval
from cmhbench.reference.training import bare
from cmhbench.tests import tiny

TIGHT = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}


def test_codes_match_the_port():
    cfg = tiny.config()
    with tempfile.TemporaryDirectory() as d:
        enc = search.encoders(tiny.context(cfg, tiny.traffic("search-text-poisson"), d, {}))
    P = bare(weights.reference_params(cfg, 7, "cpu"))       # tiny.context's seed
    g = torch.Generator().manual_seed(0)
    image = torch.randn(6, 32, 32, 3, generator=g)
    text = torch.tensor([[49406, 320, 1929, 49407] + [0] * 8,
                         [49406] + list(range(400, 409)) + [49407, 0]] * 3)
    model = enc.method.model
    with torch.no_grad():
        assert torch.allclose(model.encode_image(image), reference.image_codes(P, image),
                              atol=2e-5)
        assert torch.allclose(model.encode_text(text, text == 0),
                              reference.text_codes(P, text), atol=2e-5)


def test_three_training_steps_match_the_port():
    tr = tiny.traffic("train-b256", batch=16, pool=4, min_tokens=4, max_tokens=12,
                      warm_steps=1, reference_chunk=8)
    with tempfile.TemporaryDirectory() as d:
        out = train.run(tiny.context(tiny.config(), tr, d, TIGHT, seconds=0.2))
    assert out.attempted >= 1 and all(c.ok for c in out.checks), out.checks


def test_map_matches_the_port():
    from cmh_torch.ops.map_bucketed import calc_map_k_4dir

    g = torch.Generator().manual_seed(1)
    codes = [torch.randint(0, 2, (n, 16), generator=g).float() * 2 - 1
             for n in (40, 40, 300, 300)]
    labels = [(torch.rand(n, 6, generator=g) < 0.3).float() for n in (40, 300)]
    port = calc_map_k_4dir(*codes, *labels)
    ref = retrieval.maps_4dir(*codes, *labels)
    for a, b in zip(port, ref):
        assert abs(a - b) < 1e-6


def test_topk_matches_the_port():
    from cmh_torch.serving import RetrievalIndex

    g = torch.Generator().manual_seed(2)
    gallery = torch.randint(0, 2, (5000, 64), generator=g).float() * 2 - 1
    queries = torch.randint(0, 2, (5, 64), generator=g).float() * 2 - 1
    index = RetrievalIndex(64, device="cpu")
    index.add(gallery[:3000])
    index.add(gallery[3000:])
    dist, idx = index.search(queries, topk=10)
    packed = retrieval.pack_bytes(gallery)
    for q, d, i in zip(queries, dist, idx):
        rd, ri = retrieval.topk(retrieval.pack_bytes(q[None])[0], packed, 10)
        assert rd.tolist() == d.tolist() and ri.tolist() == i.tolist()
