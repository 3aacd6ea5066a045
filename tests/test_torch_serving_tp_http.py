"""Tensor-parallel engines behind the port's HTTP front end, and the
port's launcher (`python -m paddle_tpu_torch.serving.http.launch`).

`serve()` fronts an mp 2 engine over virtual CPU shards: a completion
gives the tokens of an mp 1 engine's own run, and `/metrics` carries the
mesh in `engine_info`. The launcher, started on the CPU on a free port
with PADDLE_TPU_MESH=dp1mp2, takes the JAX launcher's flags
(`scripts/serving_http_server.py`, read from its source), prints its
start-up line, answers one completion, and drains on SIGTERM, exiting 0
after its closing line.
"""
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.serving import SamplingParams, ServingEngine
from paddle_tpu_torch.serving.http import launch, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LAUNCHER = os.path.join(ROOT, "scripts", "serving_http_server.py")
ENGINE = dict(device="cpu", num_slots=4, max_len=64, page_size=8,
              chunk_len=8)
PROMPT = [3, 14, 15, 9, 26, 5, 35]
SOCKET_S = 60.0
START_S = 240.0


@pytest.fixture(scope="module", autouse=True)
def env():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.delenv("PADDLE_TPU_MESH", raising=False)
    mp.setenv("PADDLE_TPU_FORCE_CPU_DEVICES", "8")
    try:
        yield
    finally:
        mp.undo()
        torch.set_num_threads(n)


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=SOCKET_S)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def test_mesh_engine_behind_serve():
    model = GPTForCausalLM(GPTConfig(
        vocab_size=97, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128),
        device="cpu", seed=3).eval()
    alone = ServingEngine(model, **ENGINE).generate(
        [np.asarray(PROMPT)], [SamplingParams(max_new_tokens=6)])
    server = serve([ServingEngine(model, mesh="dp1mp2", **ENGINE)], port=0)
    try:
        addr = server.server_address[:2]
        status, body = _request(addr, "POST", "/v1/completions",
                                {"prompt": PROMPT, "max_tokens": 6})
        assert status == 200
        assert json.loads(body)["choices"][0]["token_ids"] == \
            list(alone[0].token_ids)
        status, text = _request(addr, "GET", "/metrics")
        assert status == 200
        info = [ln for ln in text.splitlines()
                if ln.startswith("paddle_serving_engine_info")]
        assert len(info) == 1
        assert 'mesh="dp1xmp2"' in info[0] and 'mp="2"' in info[0]
        shard = [ln for ln in text.splitlines() if ln.startswith(
            "paddle_serving_pool_shard_bytes_per_page")]
        assert len(shard) == 1
        page = [ln for ln in text.splitlines() if ln.startswith(
            "paddle_serving_pool_bytes_per_page")]
        assert 2 * float(shard[0].split()[-1]) == float(page[0].split()[-1])
    finally:
        server.drain(SOCKET_S)


def _flags(parser_source: str) -> list:
    return re.findall(r'add_argument\(\s*"(--[\w-]+)"', parser_source)


def test_launcher_starts_serves_and_drains():
    with open(JAX_LAUNCHER) as f:
        jax_src = f.read()
    with open(launch.__file__) as f:
        port_src = f.read()
    # the JAX launcher's flags, in its order, and its start-up and exit
    # lines
    assert _flags(port_src) == _flags(jax_src)
    for line in ('f"serving {args.replicas} replica(s) of "',
                 'f"{type(model).__name__} (vocab={cfg.vocab_size}) on "',
                 'f"{server.url} — SIGTERM drains gracefully"',
                 '"drained; exiting"'):
        assert line in jax_src and line in port_src
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, PADDLE_TPU_MESH="dp1mp2",
               PADDLE_TPU_FORCE_CPU_DEVICES="2", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.http.launch",
         "--port", str(port), "--slots", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # a launcher that never prints is killed, ending the read below
    guard = threading.Timer(START_S, proc.kill)
    guard.start()
    try:
        first = proc.stdout.readline()
        assert first.strip() == (
            f"serving 1 replica(s) of GPTForCausalLM (vocab=256) on "
            f"http://127.0.0.1:{port} — SIGTERM drains gracefully"), \
            first + proc.stderr.read() if proc.poll() is not None else first
        addr = ("127.0.0.1", port)
        status, body = _request(addr, "POST", "/v1/completions",
                                {"prompt": PROMPT, "max_tokens": 4})
        assert status == 200
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 4
        status, text = _request(addr, "GET", "/metrics")
        assert 'mesh="dp1xmp2"' in text
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=START_S)
        assert proc.returncode == 0, err
        assert out.strip().splitlines()[-1] == "drained; exiting"
    finally:
        guard.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
