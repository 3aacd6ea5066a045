"""Tensor-parallel serving in the port (serving/tp.py), held against
tests/test_serving_tp.py's contracts and the JAX package's mesh engine.

The port runs mp shards from one controller; on the CPU the shards are
virtual CPU devices (PADDLE_TPU_FORCE_CPU_DEVICES=8, as many as the JAX
package's conftest gives it). The resolver, the spec parser and the
geometry check give the JAX package's answers and texts. Engines over the
tiny Llama of that file (4 heads over 2 kv heads) and its tiny GPT (4
heads), the JAX weights moved by `convert.py`, serve at mp 2 (and
dp2 x mp2, and GPT at mp 4) the tokens of the port's mp 1 engine and of
the JAX mesh engine, with held logits bit for bit the mp 1 engine's and
within the serving parity tolerance of the JAX engine's: through the
prefix cache off, int8 and fp8 pools, the legacy step, speculative
decoding, adapters, COW and preemption swap, the embeddings lane and the
grouped walk. Each shard's pools hold its head slice of every page, the
whole-page moves and the KV fabric's frames carry every slice (an mp 2
frame is the mp 1 frame's bytes, a JAX mp 2 frame continues in a port
mp 2 engine), the per-shard read model is the JAX function's, and
`collective_counts()` reads no all-reduce and one all-gather a layer.
The mp 4 matrix rides the `slow` marker where the JAX file's does.
"""
import re
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nlp.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.nlp.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.nlp.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import SamplingParams as JaxSampling
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import prometheus_render as jax_render
from paddle_tpu.serving import tp as jtp
from paddle_tpu_torch import convert
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM)
from paddle_tpu_torch.ops.cuda.paged_attention import count_page_block_reads
from paddle_tpu_torch.serving import (SamplingParams, ServingEngine,
                                      ServingTP, collective_counts,
                                      make_random_lora, parse_mesh_spec,
                                      prometheus_render,
                                      resolve_serving_mesh,
                                      shared_prefix_groups)
from paddle_tpu_torch.serving import tp as ttp

_PALLAS_LN = "paddle_tpu.ops.pallas.layer_norm"
LLAMA = dict(vocab_size=89, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=48, max_position_embeddings=128)
GPT = dict(vocab_size=97, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=128)
ENGINE = dict(num_slots=4, max_len=64, page_size=8, chunk_len=8)
# the JAX engines' host layers that tokens do not depend on
JAX_GATES = dict(slo=False, cost_census=False)
_GATES = ("PADDLE_TPU_MESH", "PADDLE_TPU_SPEC_DECODE",
          "PADDLE_TPU_UNIFIED_STEP", "PADDLE_TPU_PAGED_ATTN",
          "PADDLE_TPU_GROUPED_ATTN", "PADDLE_TPU_KV_DTYPE",
          "PADDLE_TPU_PREEMPT", "PADDLE_TPU_MEGAKERNEL",
          "PADDLE_TPU_ADAPTERS", "PADDLE_TPU_PREFIX_CACHE",
          "PADDLE_TPU_GRAMMAR")
# f32 on both sides (tests/test_torch_llama_serving.py)
LOGIT_TOL = 1e-5
PROMPTS = [np.random.RandomState(1).randint(0, 89, size=n).astype(np.int64)
           for n in (5, 9, 17, 3, 12, 7)]


class _PallasMustNotRun:
    def __enter__(self):
        raise AssertionError("the Pallas LayerNorm path ran on the CPU")

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module", autouse=True)
def env():
    """One intra-op thread, 8 virtual CPU devices for the port's meshes,
    every serving gate at its default, and the JAX GPT on its jnp
    paths."""
    had_module = _PALLAS_LN in sys.modules
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for gate in _GATES:
        mp.delenv(gate, raising=False)
    mp.setenv("PADDLE_TPU_FORCE_CPU_DEVICES", "8")
    mp.setattr(jax.experimental, "disable_x64",
               lambda: _PallasMustNotRun(), raising=False)
    mp.setenv("PADDLE_TPU_FUSED_LN", "0")
    mp.setattr(jpa, "_INTERPRET", False)
    try:
        yield
    finally:
        mp.undo()
        torch.set_num_threads(n)
        if not had_module:
            sys.modules.pop(_PALLAS_LN, None)
            pkg = sys.modules.get("paddle_tpu.ops.pallas")
            if pkg is not None and "layer_norm" in vars(pkg):
                delattr(pkg, "layer_norm")


@pytest.fixture(scope="module")
def llama():
    """(JAX Llama, port Llama) on the same weights."""
    paddle.seed(11)
    jm = JaxLlama(JaxLlamaConfig(**LLAMA))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def gpt():
    """(JAX GPT, port GPT) on the same weights."""
    paddle.seed(7)
    jm = JaxGPT(JaxGPTConfig(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0, **GPT))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
    tm.load_state_dict(convert.from_paddle_state_dict(
        {k: v.numpy() for k, v in jm.state_dict().items()}))
    return jm, tm.eval()


def _prompts(vocab, sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int64) for n in sizes]


def _serve(eng, prompts, max_new=8, sampling=SamplingParams, **sp):
    outs = eng.generate(prompts, [sampling(max_new_tokens=max_new, **sp)
                                  for _ in prompts])
    return [list(o.token_ids) for o in outs]


def _engine(model, mesh=None, **kw):
    return ServingEngine(model, mesh=mesh, device="cpu", **{**ENGINE, **kw})


def _pair(model, prompts, mesh="dp1mp2", max_new=8, **kw):
    """(tokens, engine) of an mp 1 engine and of a mesh engine with the
    same options over the same prompts."""
    e1, e2 = _engine(model, **kw), _engine(model, mesh=mesh, **kw)
    return (_serve(e1, prompts, max_new), e1), (_serve(e2, prompts, max_new),
                                               e2)


def _same_run(a, b):
    """Equal tokens, and held logits equal bit for bit."""
    assert a[0] == b[0]
    assert torch.equal(a[1]._last_logits, b[1]._last_logits)


@pytest.fixture(scope="module")
def jax_llama(llama):
    """The JAX engines' tokens and held logits on PROMPTS, built once:
    mp 1 and dp1mp2, fp pools, and dp1mp2 over int8 pools."""
    jm, _ = llama
    out = {}
    for key, kw in (("mp1", {}), ("mp2", dict(mesh="dp1mp2")),
                    ("mp2_int8", dict(mesh="dp1mp2", kv_dtype="int8"))):
        eng = JaxEngine(jm, **ENGINE, **JAX_GATES, **kw)
        out[key] = (_serve(eng, PROMPTS, sampling=JaxSampling),
                    np.asarray(eng._last_logits), eng)
    return out


# -- the mesh's resolution -------------------------------------------------
class TestMeshResolution:
    def test_parse_specs_equal_jax(self):
        for spec in ("dp2mp4", "dp1xmp2", " DP2MP2 "):
            assert parse_mesh_spec(spec) == jtp.parse_mesh_spec(spec)
        for bad in ("mp2", "dp2", "dp0mp2", "2x4", "dp2mp"):
            with pytest.raises(ValueError) as mine:
                parse_mesh_spec(bad)
            with pytest.raises(ValueError) as theirs:
                jtp.parse_mesh_spec(bad)
            assert str(mine.value) == str(theirs.value)

    def test_env_gate(self, monkeypatch):
        monkeypatch.delenv("PADDLE_TPU_MESH", raising=False)
        assert resolve_serving_mesh(None) is None
        for spec in ("off", ""):
            monkeypatch.setenv("PADDLE_TPU_MESH", spec)
            assert resolve_serving_mesh(None) is None
            assert jtp.resolve_serving_mesh(None) is None
        monkeypatch.setenv("PADDLE_TPU_MESH", "dp1mp2")
        tp = resolve_serving_mesh(None)
        assert tp.shape == jtp.resolve_serving_mesh(None).shape == "dp1xmp2"
        assert (tp.dp, tp.mp) == (1, 2)
        assert resolve_serving_mesh(False) is None
        monkeypatch.setenv("PADDLE_TPU_MESH", "nonsense")
        with pytest.raises(ValueError, match="dp2mp4"):
            resolve_serving_mesh(None)

    def test_overrides(self):
        assert resolve_serving_mesh((2, 2)).shape == \
            jtp.resolve_serving_mesh((2, 2)).shape == "dp2xmp2"
        tp = ServingTP(1, 2)
        assert resolve_serving_mesh(tp) is tp
        assert repr(tp) == repr(jtp.ServingTP(1, 2)) == "ServingTP(dp1xmp2)"
        assert tp.size == 2 and ServingTP(2, 4).size == 8
        # a jax Mesh cannot reach the port: any other type is refused
        # with the JAX resolver's last text
        for bad in (3.5, jax.sharding.Mesh(np.asarray(jax.devices()[:2])
                                           .reshape(1, 2), ("dp", "mp"))):
            with pytest.raises(ValueError, match="tuple") as mine:
                resolve_serving_mesh(bad)
            if isinstance(bad, float):
                with pytest.raises(ValueError) as theirs:
                    jtp.resolve_serving_mesh(bad)
                assert str(mine.value) == str(theirs.value)

    def test_too_many_devices_and_repeats(self, monkeypatch):
        with pytest.raises(ValueError, match="devices"):
            ServingTP(4, 4)            # 16 > the 8 virtual devices
        with pytest.raises(ValueError, match="devices"):
            jtp.ServingTP(4, 4)
        monkeypatch.setenv("PADDLE_TPU_FORCE_CPU_DEVICES", "1")
        assert ttp.visible_devices() == [torch.device("cpu")]
        with pytest.raises(ValueError, match="needs 2 devices but only 1"):
            ServingTP(1, 2)
        # a caller may lay several shards on one device
        tp = ServingTP(1, 4, devices=["cpu"] * 4)
        assert tp.devices == [torch.device("cpu")] * 4


class TestGeometryValidation:
    def test_errors_equal_jax(self, llama):
        _, tm = llama
        for mesh, dims in (((1, 4), dict(n_kv=2, n_heads=4, hidden=32)),
                           ((1, 4), dict(n_kv=4, n_heads=6, hidden=48)),
                           ((1, 3), dict(n_kv=2, n_heads=4, hidden=32)),
                           ((1, 2), dict(n_kv=2, n_heads=4, hidden=33))):
            with pytest.raises(ValueError) as mine:
                ServingTP(*mesh).validate_geometry(**dims)
            with pytest.raises(ValueError) as theirs:
                jtp.ServingTP(*mesh).validate_geometry(**dims)
            assert str(mine.value) == str(theirs.value)
        with pytest.raises(ValueError) as ei:
            _engine(tm, mesh="dp1mp4")
        msg = str(ei.value)
        assert "H_kv=2" in msg and "mp=4" in msg and "[1, 2]" in msg

    def test_validation_happens_at_construction(self, llama):
        with pytest.raises(ValueError, match="H_kv=2"):
            _engine(llama[1], mesh="dp2mp4")

    def test_legal_mp_places_contiguous_shard_pools(self, llama):
        eng = _engine(llama[1], mesh="dp1mp2", kv_dtype="int8")
        assert (eng.mp, eng.dp, eng.tp.shape) == (2, 1, "dp1xmp2")
        assert eng.page_bytes_per_chip * 2 == eng.page_bytes
        for s, pools in enumerate(eng._pools.pools):
            for k, v, ks, vs in pools:
                assert k.shape == (eng.num_pages, 8, 1, 8)
                assert ks.shape == (eng.num_pages, 8, 1)
                assert all(t.is_contiguous() for t in (k, v, ks, vs))
        # the shards' runs of the projections are the engine's own
        # copies: the model's parameters are untouched
        w = eng._pools.weights[1][0]["q_proj"][0]
        torch.testing.assert_close(
            w, llama[1].llama.layers[0].self_attn.q_proj.weight[16:],
            rtol=0, atol=0)
        assert w.data_ptr() != \
            llama[1].llama.layers[0].self_attn.q_proj.weight.data_ptr()


# -- tokens and logits -------------------------------------------------------
class TestTokenIdentity:
    def test_mp2_matches_mp1_and_the_jax_mesh_engine(self, llama,
                                                     jax_llama):
        one, two = _pair(llama[1], PROMPTS)
        _same_run(one, two)
        assert two[0] == jax_llama["mp2"][0] == jax_llama["mp1"][0]
        np.testing.assert_allclose(two[1]._last_logits.numpy(),
                                   jax_llama["mp2"][1], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)

    def test_dp2_mp2_full_mesh(self, llama, jax_llama):
        one, full = _pair(llama[1], PROMPTS, mesh=(2, 2))
        _same_run(one, full)
        assert full[0] == jax_llama["mp2"][0]

    def test_mp2_prefix_cache_off(self, llama):
        _same_run(*_pair(llama[1], _prompts(89, (6, 13, 8), 3),
                         prefix_cache=False))

    def test_mp2_int8_pool(self, llama, jax_llama):
        one, two = _pair(llama[1], PROMPTS, kv_dtype="int8")
        _same_run(one, two)
        assert two[0] == jax_llama["mp2_int8"][0]

    def test_mp2_fp8_pool(self, llama):
        _same_run(*_pair(llama[1], PROMPTS, kv_dtype="fp8"))

    @pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
    def test_mp2_legacy_step(self, gpt, kv_dtype):
        # prefill chunks through the gather branch, the decode step
        # through K9's (K7's) plain version, at 2 heads a shard
        _same_run(*_pair(gpt[1], PROMPTS, unified=False, kv_dtype=kv_dtype))

    def test_mp2_spec_decode(self, llama):
        rs = np.random.RandomState(4)
        block = rs.randint(0, 89, size=6)
        prompts = [np.concatenate([block, block, block[:3]])
                   for _ in range(3)]
        one, two = _pair(llama[1], prompts, spec="ngram:3")
        _same_run(one, two)
        assert two[1].metrics.snapshot()["spec_drafted_tokens"] > 0

    def test_mp2_draft_model_stays_on_the_lead(self, llama):
        # the model tier's draft engine keeps its own unsharded pools;
        # the verify step takes the shard route; the megakernel gate
        # drops silently on a mesh (the JAX rule)
        one, two = _pair(llama[1], PROMPTS[:3], spec="model:2",
                         megakernel=True)
        _same_run(one, two)
        assert one[1].megakernel and not two[1].megakernel
        assert two[1]._draft is not None
        assert two[1]._draft._pools[0][0].shape[2] == 2

    def test_mp2_adapters(self, llama):
        loras = [make_random_lora(2, 32, 32, 16, rank=4,
                                  rng=np.random.RandomState(9 + i), amp=0.2)
                 for i in range(2)]
        runs = []
        for mesh in (None, "dp1mp2"):
            eng = _engine(llama[1], mesh=mesh, adapters=True,
                          adapter_pages=2)
            for i, w in enumerate(loras):
                eng.adapters.register(f"t{i}", w)
            outs = eng.generate(PROMPTS, [
                SamplingParams(max_new_tokens=6, adapter_id=i % 3)
                for i in range(len(PROMPTS))])
            runs.append(([list(o.token_ids) for o in outs], eng))
        _same_run(*runs)
        eng = runs[1][1]
        # the q/k/v B pools split over the shards' columns; the lead
        # keeps the A pools and the o pair
        assert eng.adapters.pools[0][1] is None
        aq, bq, ak, bk, av, bv = eng.adapters.shard_cols[1][0]
        assert bq.shape[-1] == 16 and bk.shape[-1] == bv.shape[-1] == 8
        assert aq is eng.adapters.pools[0][0]
        assert not runs[1][1].megakernel


# -- whole-page moves -------------------------------------------------------
def _pools_equal(e1, e2):
    """The mesh engine's shard pools, concatenated over the head axis,
    hold the mp 1 engine's bytes."""
    for i, layer in enumerate(e1._pools):
        for j, t in enumerate(layer):
            if t is None:
                continue
            parts = [p[i][j] for p in e2._pools.pools]
            whole = torch.cat([p.view(torch.uint8) if p.dtype.itemsize == 1
                               and p.is_floating_point() else p
                               for p in parts], dim=2)
            ref = (t.view(torch.uint8) if t.dtype.itemsize == 1
                   and t.is_floating_point() else t)
            assert torch.equal(whole, ref)


class TestPageMoves:
    @pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
    def test_cow_and_swap_on_a_sharded_pool(self, llama, kv_dtype):
        runs = []
        for mesh in (None, "dp1mp2"):
            eng = _engine(llama[1], mesh=mesh, num_slots=2, num_pages=17,
                          kv_dtype=kv_dtype)
            base = _prompts(89, (13,), 6)[0]
            _serve(eng, [base], 3)
            for seed in (7, 8):      # two copy-on-writes of its last page
                tail = _prompts(89, (5,), seed)[0]
                _serve(eng, [np.concatenate([base, tail])], 3)
            lo = [eng.add_request(p, SamplingParams(max_new_tokens=10,
                                                    priority=5))
                  for p in _prompts(89, (9, 12), 9)]
            for _ in range(4):
                eng.step()
            hi = eng.add_request(_prompts(89, (8,), 10)[0],
                                 SamplingParams(max_new_tokens=6,
                                                priority=0))
            eng.run()
            assert sum(r.preemptions for r in [*lo, hi]) >= 1
            assert eng.metrics.snapshot()["swapped_in_pages"] > 0
            runs.append(([list(r.output_tokens) for r in [*lo, hi]], eng))
        _same_run(*runs)
        _pools_equal(runs[0][1], runs[1][1])

    def test_embed_lane_restores_every_shard(self, gpt):
        runs = []
        for mesh in (None, "dp1mp2"):
            eng = _engine(gpt[1], mesh=mesh)
            p = _prompts(97, (30,), 12)[0]
            outs = eng.generate([p, p[:17]], [SamplingParams(max_new_tokens=4),
                                              SamplingParams(embed=True)])
            runs.append((outs, eng))
        (o1, e1), (o2, e2) = runs
        assert o1[0].token_ids == o2[0].token_ids
        np.testing.assert_array_equal(o1[1].embedding, o2[1].embedding)
        _pools_equal(e1, e2)


# -- the grouped walk and the read model --------------------------------------
class TestGrouped:
    def test_grouped_walk_on_a_sharded_pool_equals_flat(self, llama):
        # the grouped walk's plain version sums in another order than the
        # per-row one's on the CPU (the card's kernels agree bit for bit):
        # grouped equals flat in tokens, and each equals its mp 1 twin bit
        # for bit
        sysp = _prompts(89, (21,), 13)[0]
        prompts = [np.concatenate([sysp, t])
                   for t in _prompts(89, (3, 5, 2, 9), 14)]
        runs = {}
        for grouped in (True, False):
            for mesh in (None, "dp1mp2"):
                eng = _engine(llama[1], mesh=mesh, grouped=grouped)
                _serve(eng, [sysp], 2)           # warm the radix tree
                runs[grouped, mesh] = (_serve(eng, prompts, 6), eng)
            _same_run(runs[grouped, None], runs[grouped, "dp1mp2"])
        assert runs[True, "dp1mp2"][0] == runs[False, "dp1mp2"][0]
        assert runs[True, "dp1mp2"][1].metrics.snapshot()[
            "shared_page_reads_saved_total"] > 0

    def test_per_shard_read_model_equals_jax(self):
        rng = np.random.RandomState(0)
        for _ in range(30):
            s = int(rng.randint(1, 6))
            pt = rng.randint(1, 9, size=(s, 4)).astype(np.int32)
            pt[1:, :2] = pt[0, :2] if s > 1 else pt[0, :2]
            pos = rng.randint(0, 28, size=s)
            q_len = rng.randint(0, 3, size=s)
            gid, _, gcn = shared_prefix_groups(pt, q_len)
            fused = dict(head_dim=16, kv_elt=1, scale_elt=4, lora_bytes=96)
            for n_kv, mp in ((4, 1), (4, 2), (4, 4), (8, 2), (1, 1)):
                for g in ((), (gid, gcn)):
                    args = (pt, pos, q_len, *g)
                    kw = dict(page_size=8, n_kv=n_kv, mp=mp)
                    assert count_page_block_reads(*args, **kw) == \
                        jpa.count_page_block_reads(*args, **kw)
                    assert count_page_block_reads(*args, fused=fused,
                                                  **kw) == \
                        jpa.count_page_block_reads(*args, fused=fused, **kw)


# -- collectives ---------------------------------------------------------------
class TestCollectives:
    def test_counted_transfers(self, llama):
        _, two = _pair(llama[1], _prompts(89, (5, 8), 11))
        eng = two[1]
        counts = eng.collective_counts()
        assert counts == {"all_reduce": 0, "all_gather": eng.n_layers,
                          "reduce_scatter": 0, "all_to_all": 0,
                          "collective_permute": 0,
                          "broadcast": eng.n_layers}
        # the HLO-text census is the JAX function's
        for text in ("x = all-gather(y)\nz = all-reduce(w)",
                     "a = all-gather-start(b)\nc = collective-permute(d)"
                     "\ne = reduce-scatter(f) all-to-all(g)"):
            assert collective_counts(text) == jtp.collective_counts(text)

    def test_collective_counts_needs_mesh_and_a_step(self, llama):
        with pytest.raises(ValueError, match="mesh"):
            _engine(llama[1]).collective_counts()
        with pytest.raises(ValueError, match="no unified step"):
            _engine(llama[1], mesh="dp1mp2").collective_counts()

    def test_flight_record_carries_per_step_collectives(self, llama,
                                                        jax_llama):
        runs = {}
        for mesh in (None, "dp1mp2"):
            eng = _engine(llama[1], mesh=mesh)
            _serve(eng, _prompts(89, (6,), 12))
            runs[mesh] = eng.obs.flight.snapshot()["steps"]
        assert {r["collectives"] for r in runs["dp1mp2"]} == {2}
        assert {r["collectives"] for r in runs[None]} == {0}
        jrec = jax_llama["mp2"][2].obs.flight.snapshot()["steps"][-1]
        assert jrec["collectives"] == runs["dp1mp2"][-1]["collectives"]
        # the legacy step: one count a launch (each chunk, each decode)
        eng = _engine(llama[1], mesh="dp1mp2", unified=False)
        _serve(eng, _prompts(89, (12,), 12), 3)
        recs = eng.obs.flight.snapshot()["steps"]
        launches = eng.metrics.snapshot()["prefill_chunks"] + sum(
            r["decode_tokens"] > 0 for r in recs)
        assert [r["collectives"] for r in recs] == [2, 4, 2, 2]
        assert sum(r["collectives"] for r in recs) == 2 * launches


# -- observability --------------------------------------------------------------
class TestObservability:
    def test_metrics_debug_state_and_census(self, llama, jax_llama):
        _, two = _pair(llama[1], PROMPTS)
        eng, jeng = two[1], jax_llama["mp2"][2]
        snap = eng.metrics.snapshot()
        assert (snap["mesh"], snap["mp"], snap["dp"]) == ("dp1xmp2", 2, 1)
        assert snap["pool"]["shard_bytes_per_page"] * 2 == \
            snap["pool"]["bytes_per_page"]
        jsnap = jeng.metrics.snapshot()
        for key in ("mesh", "mp", "dp"):
            assert snap[key] == jsnap[key]
        assert snap["pool"]["shard_bytes_per_page"] == \
            jsnap["pool"]["shard_bytes_per_page"]
        cfg, jcfg = eng.debug_state()["config"], jeng.debug_state()["config"]
        assert (cfg["mesh"], cfg["mp"], cfg["dp"]) == \
            (jcfg["mesh"], jcfg["mp"], jcfg["dp"]) == ("dp1xmp2", 2, 1)
        # the "model" census counts one shard's page walk
        e1 = _engine(llama[1])
        _serve(e1, PROMPTS[:1], 2)
        walk = (eng.cost_census()["bytes_accessed"],
                e1.cost_census()["bytes_accessed"])
        params = sum(t.numel() * 4 for t in llama[1].parameters())
        assert walk[1] - params == 2 * (walk[0] - params)

    def test_prometheus_mesh_lines_equal_jax(self, llama, jax_llama):
        _, two = _pair(llama[1], PROMPTS)
        lines = [prometheus_render({"r0": two[1].metrics.snapshot()}),
                 jax_render({"r0": jax_llama["mp2"][2].metrics.snapshot()})]
        picked = [[ln for ln in text.splitlines()
                   if ln.startswith(("paddle_serving_engine_info",
                                     "paddle_serving_pool_shard_bytes"))]
                  for text in lines]
        assert picked[0] == picked[1] and len(picked[0]) == 2
        assert 'mesh="dp1xmp2"' in picked[0][0]
        rx = re.compile(
            r'^[A-Za-z_:][A-Za-z0-9_:]*'
            r'(\{[A-Za-z0-9_]+="[^"]*"(,[A-Za-z0-9_]+="[^"]*")*\})?'
            r' -?[0-9.eE+\-]+(inf|nan)?$')
        for ln in lines[0].splitlines():
            if ln and not ln.startswith("#"):
                assert rx.match(ln), ln


# -- the KV fabric ----------------------------------------------------------------
class TestFabric:
    @pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
    def test_mp2_frame_equals_mp1_bytes(self, gpt, kv_dtype):
        frames = []
        for mesh in (None, "dp1mp2"):
            eng = _engine(gpt[1], mesh=mesh, kv_dtype=kv_dtype)
            p = _prompts(97, (30,), 12)[0]
            _serve(eng, [p], 4)
            frames.append(eng.export_prefix_frame(p))
        assert frames[0] is not None and frames[0] == frames[1]
        back = _engine(gpt[1], mesh="dp1mp2", kv_dtype=kv_dtype)
        assert back.import_prefix_frame(frames[0]) == 3
        assert back.export_prefix_frame(p) == frames[0]

    def test_jax_mp2_frame_continues_in_a_port_mp2_engine(self, gpt):
        jm, tm = gpt
        prompt = _prompts(97, (26,), 15)[0]
        ja = JaxEngine(jm, mesh="dp1mp2", **ENGINE, **JAX_GATES)
        t1 = _serve(ja, [prompt], 1, JaxSampling)[0]
        seq = np.concatenate([prompt, t1]).astype(np.int64)
        frame = ja.export_prefix_frame(seq)
        want = _serve(ja, [seq], 6, JaxSampling)
        tb = _engine(tm, mesh="dp1mp2")
        assert tb.import_prefix_frame(frame) == 3
        assert _serve(tb, [seq], 6) == want
        assert tb.export_prefix_frame(seq) == frame


# -- GPT at mp 4 (one head a shard) ------------------------------------------------
class TestMp4Matrix:
    def _pair(self, gpt, **kw):
        return _pair(gpt[1], _prompts(97, (5, 9, 17, 3, 12, 7), 20),
                     mesh="dp1mp4", **kw)

    def test_mp4_fp(self, gpt):
        one, four = self._pair(gpt)
        _same_run(one, four)
        counts = four[1].collective_counts()
        assert counts["all_reduce"] == 0
        assert counts["all_gather"] == four[1].n_layers

    @pytest.mark.slow
    @pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                    dict(kv_dtype="fp8"),
                                    dict(prefix_cache=False),
                                    dict(spec="ngram:3"),
                                    dict(grouped=False)],
                             ids=["int8", "fp8", "prefix_off", "spec",
                                  "ungrouped"])
    def test_mp4_options(self, gpt, kw):
        _same_run(*self._pair(gpt, **kw))

    @pytest.mark.slow
    def test_mp4_preempt_swap(self, gpt):
        outs = {}
        for mesh in (None, "dp2mp4"):
            eng = _engine(gpt[1], mesh=mesh, num_slots=2, num_pages=17)
            lo = [eng.add_request(p, SamplingParams(max_new_tokens=10,
                                                    priority=5))
                  for p in _prompts(97, (9, 12), 21)]
            for _ in range(4):
                eng.step()
            hi = eng.add_request(_prompts(97, (8,), 22)[0],
                                 SamplingParams(max_new_tokens=6,
                                                priority=0))
            eng.run()
            assert sum(r.preemptions for r in [*lo, hi]) >= 1
            outs[mesh] = [list(r.output_tokens) for r in [*lo, hi]]
        assert outs[None] == outs["dp2mp4"]


def test_dryrun_multichip_serving_phase():
    """The port's counterpart of `__graft_entry__.dryrun_multichip`'s
    serving phase on 8 devices: a dp2 x mp2 engine over a GPT of vocab
    256, hidden 64, 2 layers, 4 heads gives the single-device tokens
    with no all-reduce and one all-gather a layer."""
    model = GPTForCausalLM(GPTConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=128,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        device="cpu", seed=0).eval()
    prompts = _prompts(256, (5, 11, 17, 8), 5)
    tokens = {}
    for mesh in (None, "dp2mp2"):
        eng = _engine(model, mesh=mesh)
        tokens[mesh] = _serve(eng, prompts)
        if mesh is not None:
            coll = eng.collective_counts()
            assert coll["all_reduce"] == 0
            assert coll["all_gather"] == eng.n_layers
    assert tokens[None] == tokens["dp2mp2"]
