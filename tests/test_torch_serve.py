"""The port's inference service (esrganplus_tpu_torch/cli/serve.py) on
``--device cpu``: the JAX package's tests/test_serve.py cases (endpoints,
image round trip, error paths, the x8 and tiled modes, exact stats under
concurrency), and the response held against JAX's ``SRInferencer`` on the
same tiny checkpoint. The server runs in a thread; no JAX server is
started."""

import argparse
import http.client
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from esrganplus_tpu.models.rrdb import RRDBNetConfig, init_rrdbnet

CFG = RRDBNetConfig(nf=8, nb=1, gc=4, upscale=4)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    from esrganplus_tpu.convert.pth import generator_to_state_dict

    path = os.path.join(tmp_path_factory.mktemp("serve"), "tiny.pth")
    params = init_rrdbnet(jax.random.PRNGKey(0), CFG)
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in generator_to_state_dict(params, CFG).items()}, path)
    return path


def _args(pth, **kw):
    opts = dict(model=pth, host="127.0.0.1", port=0, dtype="fp32", pad_multiple=16, tile=0,
                x8=False, noise_seed=None, device="cpu")
    opts.update(kw)
    return argparse.Namespace(**opts)


def _start(args):
    from esrganplus_tpu_torch.cli.serve import make_server

    srv, inf = make_server(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, inf


@pytest.fixture(scope="module")
def server(pth):
    srv, _ = _start(_args(pth))
    yield srv.server_address
    srv.shutdown()
    srv.server_close()


def _conn(addr):
    return http.client.HTTPConnection(addr[0], addr[1], timeout=60)


def _post(addr, body):
    c = _conn(addr)
    c.request("POST", "/upscale", body=body, headers={"Content-Type": "image/png"})
    r = c.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def _png(h, w, seed):
    from esrganplus_tpu_torch.ops.image_io import encode_png

    img = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)
    return img, encode_png(img)


def test_healthz_and_stats(server):
    c = _conn(server)
    c.request("GET", "/healthz")
    r = c.getresponse()
    assert r.status == 200
    body = json.loads(r.read())
    assert body["status"] == "ok" and body["model"] == {"nb": 1, "nf": 8, "gc": 4, "upscale": 4}
    assert body["device"] == "cpu"
    c.request("GET", "/stats")
    assert json.loads(c.getresponse().read())["requests"] >= 0


def test_upscale_roundtrip(server):
    from esrganplus_tpu_torch.ops.image_io import decode_img

    _, payload = _png(20, 24, 0)
    status, ctype, body = _post(server, payload)
    assert status == 200 and ctype == "image/png"
    assert decode_img(body).shape == (80, 96, 3)  # x4, cropped back from the pad
    c = _conn(server)
    c.request("GET", "/stats")
    stats = json.loads(c.getresponse().read())
    assert stats["requests"] >= 1 and stats["out_mpix"] > 0


def test_upscale_matches_jax_inferencer(server, pth):
    """An fp32 response decodes to JAX's SRInferencer.upscale of the same
    image (padded alike) through tensor2img, within one level."""
    from esrganplus_tpu.infer import SRInferencer, load_generator
    from esrganplus_tpu.ops.image_io import img2tensor, tensor2img
    from esrganplus_tpu_torch.ops.image_io import decode_img

    img, payload = _png(21, 19, 3)
    status, _, body = _post(server, payload)
    assert status == 200
    params, cfg, _ = load_generator(pth)
    want = tensor2img(SRInferencer(params, cfg, pad_multiple=16).upscale(
        img2tensor(img.astype(np.float32) / 255.0)))
    got = decode_img(body)
    assert got.shape == want.shape == (84, 76, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_upscale_bad_payload(server):
    status, _, body = _post(server, b"not an image")
    assert status == 400
    assert "bad image payload" in json.loads(body)["error"]


def test_unknown_path(server):
    c = _conn(server)
    c.request("GET", "/nope")
    assert c.getresponse().status == 404
    c.request("POST", "/nope", body=b"")
    assert c.getresponse().status == 404


@pytest.mark.parametrize("mode", ["x8", "tile", "noise"])
def test_serving_modes_warm_and_serve(pth, mode):
    """--x8 must not recurse (upscale_x8 calls self.upscale internally);
    --tile and --noise-seed warm up and serve; the noise mode answers the
    same bytes twice (the seed re-drawn for every forward)."""
    from esrganplus_tpu_torch.ops.image_io import decode_img

    kw = {"x8": dict(x8=True, pad_multiple=8), "tile": dict(tile=16),
          "noise": dict(noise_seed=5)}[mode]
    srv, _ = _start(_args(pth, **kw))
    try:
        _, payload = _png(20, 20, 1)
        status, _, body = _post(srv.server_address, payload)
        assert status == 200 and decode_img(body).shape == (80, 80, 3)
        if mode == "noise":
            assert _post(srv.server_address, payload)[2] == body
    finally:
        srv.shutdown()
        srv.server_close()


def test_tile_x8_mutually_exclusive(pth):
    from esrganplus_tpu_torch.cli.serve import make_server

    with pytest.raises(SystemExit, match="mutually exclusive"):
        make_server(_args(pth, tile=64, x8=True))


def test_concurrent_requests_count_exactly(server):
    """N parallel POSTs must all succeed and be counted exactly N times —
    the stats read-modify-writes run under the lock (ThreadingHTTPServer
    spawns one handler thread per request)."""
    c0 = _conn(server)
    c0.request("GET", "/stats")
    before = json.loads(c0.getresponse().read())["requests"]
    _, png = _png(16, 16, 5)
    results = []
    threads = [threading.Thread(target=lambda: results.append(_post(server, png)[0]))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [200] * 6
    c0.request("GET", "/stats")
    after = json.loads(c0.getresponse().read())
    assert after["requests"] == before + 6
    assert after["latency_ewma_s"] > 0


def test_server_needs_a_card_unless_asked_for_cpu(pth):
    from esrganplus_tpu_torch.cli.serve import build_parser, make_server

    assert build_parser().parse_args([pth]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        make_server(_args(pth, device="cuda"))
