"""The port's HTTP serving layer (moldiff_tpu_torch/serve) on the CPU: the
cases of tests/test_serve.py against the torch service, on a tiny
checkpoint the JAX package writes (T = 8, node_dim 16), and a worker's
failure reaching its requests."""
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

from moldiff_tpu.models.moldiff import MolDiff as JMolDiff
from moldiff_tpu.train.trainer import TrainState, save_checkpoint
from moldiff_tpu_torch.serve import build_service_from_checkpoint, make_http_server
from test_serve import _tiny_full_config


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    cfg = _tiny_full_config()
    model = JMolDiff(cfg.model, 8, 6)
    params = model.init_params(jax.random.key(0))
    path = str(tmp_path_factory.mktemp("serve") / "tiny.ckpt")
    save_checkpoint(path, TrainState(params, None, np.int32(0), None), model_config=cfg)
    return path


def _build(ckpt_path, **kw):
    return build_service_from_checkpoint(ckpt_path, batch_size=8, buckets=[12], device="cpu",
                                         **kw)


@pytest.fixture(scope="module")
def service(ckpt_path):
    return _build(ckpt_path, max_mols_per_request=16)


def _http(url, data=None):
    req = urllib.request.Request(url, data=json.dumps(data).encode() if data is not None
                                 else None)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestService:
    def test_generate_returns_pool(self, service):
        out = service.generate(2, seed=0)
        assert isinstance(out["smiles"], list) and isinstance(out["num_failed"], int)
        assert out["seed"] == 0
        assert all("." not in s for s in out["smiles"])

    def test_generate_deterministic_for_seed(self, service):
        a = service.generate(2, seed=7)
        b = service.generate(2, seed=7)
        assert a["smiles"] == b["smiles"] and a["num_failed"] == b["num_failed"]

    def test_generate_validates_num_mols(self, service):
        with pytest.raises(ValueError):
            service.generate(0)
        with pytest.raises(ValueError):
            service.generate(10_000)

    def test_sdf_format(self, service):
        out = service.generate(2, seed=1, want_sdf=True)
        assert len(out["sdf"]) == len(out["smiles"])
        for block in out["sdf"]:
            assert "V2000" in block and block.endswith("$$$$\n")

    def test_warmup_compiles_buckets(self, service):
        service.warmup()
        health = service.health()
        assert health["warm"] == [12] and health["device"] == "cpu"
        assert health["batch_size"] == 8 and not health["guided"]


class TestHTTP:
    @pytest.fixture(scope="class")
    def server(self, service):
        srv = make_http_server(service, "127.0.0.1", 0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_port}"
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)

    def test_health(self, server):
        code, body = _http(server + "/health")
        assert code == 200 and body["status"] == "ok" and body["buckets"] == [12]

    def test_generate_roundtrip(self, server):
        code, body = _http(server + "/generate", {"num_mols": 2, "seed": 3, "format": "sdf"})
        assert code == 200
        assert isinstance(body["smiles"], list) and len(body["sdf"]) == len(body["smiles"])

    def test_stats_accumulate(self, server, service):
        before = service.stats["requests"]
        _http(server + "/generate", {"num_mols": 1, "seed": 4})
        code, stats = _http(server + "/stats")
        assert code == 200 and stats["requests"] == before + 1 and "avg_generate_s" in stats

    def test_bad_request_is_400(self, server):
        code, body = _http(server + "/generate", {"num_mols": 0})
        assert code == 400 and "error" in body

    def test_unknown_path_is_404(self, server):
        code, _ = _http(server + "/nope")
        assert code == 404


class TestCLIWiring:
    def test_guidance_requires_bond_ckpt(self, ckpt_path):
        from moldiff_tpu_torch.serve import __main__ as serve_main

        with pytest.raises(SystemExit):
            serve_main.main(["--ckpt", ckpt_path, "--guidance", "uncertainty", "1e-4",
                             "--port", "0", "--device", "cpu"])


class TestCoalescing:
    """batch_window_ms merges concurrent unseeded requests into one pool;
    seeded requests bypass it; close() shuts the worker down, and a worker's
    failure reaches every request of its batch."""

    @pytest.fixture(scope="class")
    def batching_service(self, ckpt_path):
        svc = _build(ckpt_path, max_mols_per_request=16, batch_window_ms=150.0)
        yield svc
        svc.close()

    def test_concurrent_requests_share_a_batch(self, batching_service):
        svc = batching_service
        svc.warmup()
        results, errors = [None] * 3, []

        def call(i):
            try:
                results[i] = svc.submit(num_mols=2)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        b0 = svc.stats["batches"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        for r in results:
            # random weights: the pool may stop short of the target; the
            # contract is the partition's accounting
            assert r is not None and len(r["smiles"]) <= 2
            assert r["num_failed"] == 2 - len(r["smiles"])
        assert 1 <= svc.stats["batches"] - b0 < 3
        assert any(r["coalesced"] >= 2 for r in results)
        assert len({r["seed"] for r in results if r["coalesced"] >= 2}) <= 2

    def test_seeded_request_bypasses_coalescing(self, batching_service):
        out = batching_service.submit(num_mols=2, seed=42)
        assert "coalesced" not in out
        assert batching_service.submit(num_mols=2, seed=42)["smiles"] == out["smiles"]

    def test_submit_validates_num_mols(self, batching_service):
        with pytest.raises(ValueError):
            batching_service.submit(num_mols=0)
        with pytest.raises(ValueError):
            batching_service.submit(num_mols=999)

    def test_close_is_idempotent(self, ckpt_path):
        svc = _build(ckpt_path, batch_window_ms=50.0)
        svc.close()
        svc.close()
        assert svc.generate(1)["smiles"] is not None   # the direct path still works
        with pytest.raises(RuntimeError, match="closed"):
            svc.submit(num_mols=1)

    def test_worker_error_reaches_requests(self, ckpt_path):
        svc = _build(ckpt_path, batch_window_ms=100.0)

        def broken(*a, **k):
            raise RuntimeError("chain failed")

        svc.sampler.generate = broken
        errors, threads = [], []
        for _ in range(2):
            def call():
                try:
                    svc.submit(num_mols=1)
                except RuntimeError as e:
                    errors.append(str(e))
            threads.append(threading.Thread(target=call))
            threads[-1].start()
        for t in threads:
            t.join(timeout=60)
        svc.close()
        assert not any(t.is_alive() for t in threads)
        assert errors == ["chain failed"] * 2
