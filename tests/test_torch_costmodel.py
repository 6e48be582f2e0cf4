"""The port's Table-1 cost model against the JAX package's.

The port keeps every formula and changes only the constants (one H100
instead of a TPU v5e).  So each public function is held to the reference
at a grid of arguments with the constants held equal -- the reference's
link, peak and HBM rate passed to both sides -- to a relative error of
1e-12 (the same float operations in the same order; the bound leaves room
for nothing but a differently ordered sum).  Then the reference's cost
properties (``tests/test_costmodel_2d.py`` and ``tests/test_properties.py``)
run on the port's module with its own H100 constants, and
``fit_link`` recovers a link from costs it generated.
"""
import math

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import costmodel as rm
from repro_torch.core import costmodel as cm

REL = 1e-12
LINK = cm.LinkClass(rm.ICI.t_s, rm.ICI.t_w)          # the reference's ICI
RLINK = rm.ICI
DCI = (cm.LinkClass(rm.DCI.t_s, rm.DCI.t_w), rm.DCI)
HW = dict(peak_flops=rm.PEAK_FLOPS_BF16, hbm_bw=rm.HBM_BW)
PS = [1, 2, 3, 4, 8, 16, 64, 256]
MS = [0, 1, 1000, 2**20, 1e9]


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, str):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)


def test_public_functions_are_the_references():
    """Every public function of the reference exists in the port; only the
    TPU constants and their link classes are renamed."""
    fns = lambda m: {n for n in dir(m) if not n.startswith("_")
                     and callable(getattr(m, n)) and getattr(m, n).__module__ == m.__name__}
    assert fns(rm) <= fns(cm)
    assert fns(cm) - fns(rm) == {"link_terms", "fit_link"}
    assert (cm.PEAK_FLOPS_BF16, cm.HBM_BW, cm.NVLINK_BW, cm.HBM_PER_CHIP) == \
        (989e12, 3.35e12, 450e9, 80e9)
    assert cm.NVLINK == cm.LinkClass(cm.NVLINK_LATENCY, 1 / cm.NVLINK_BW)


@pytest.mark.parametrize("name", ["t_reduce", "t_broadcast", "t_all_gather", "t_all_to_all",
                                  "t_all_reduce", "t_reduce_scatter", "t_scan", "t_shift",
                                  "t_ring_shift", "t_reduce_scatter_ring"])
def test_table1_terms(name):
    fp, fr = getattr(cm, name), getattr(rm, name)
    for m in MS:
        for p in PS:
            for (pl, rl) in ((LINK, RLINK), DCI):
                _same(fp(m, p, pl), fr(m, p, rl))
                if name in ("t_reduce", "t_scan", "t_reduce_scatter_ring"):
                    _same(fp(m, p, pl, t_lambda=3e-7), fr(m, p, rl, t_lambda=3e-7))
    assert cm.t_map(1.5) == rm.t_map(1.5)


def test_roofline_and_model_flops():
    for flops, byts, coll, chips in [(1e12, 1e9, 0.0, 1), (3e17, 2e14, 5e13, 256),
                                     (1e6, 1e3, 1e15, 512)]:
        _same(cm.roofline_terms(flops, byts, coll, chips, link_bw=rm.ICI_BW, **HW),
              rm.roofline_terms(flops, byts, coll, chips))
    for n, d in [(3e9, 2048), (1e12, 1.0)]:
        _same(cm.model_flops_train(n, d), rm.model_flops_train(n, d))
        _same(cm.model_flops_decode(n, d), rm.model_flops_decode(n, d))


@pytest.mark.parametrize("n_params", [1e8, 3.2e9, 4e11])
def test_serve_costs(n_params):
    for batch in (1, 8, 64, 1 << 20):
        for kv in (0.0, 1e6, 1e9):
            for chips, bpp, ovh in ((1, 2, 0.0), (8, 1, 1e-3)):
                kw = dict(chips=chips, bytes_per_param=bpp, **HW)
                _same(cm.decode_step_cost(n_params, batch, kv, overhead_s=ovh, **kw),
                      rm.decode_step_cost(n_params, batch, kv, overhead_s=ovh, **kw))
                _same(cm.paged_decode_step_cost(n_params, batch, kv, block=16,
                                                kv_token_bytes=4096.0, overhead_s=ovh, **kw),
                      rm.paged_decode_step_cost(n_params, batch, kv, block=16,
                                                kv_token_bytes=4096.0, overhead_s=ovh, **kw))
    for prompt in (1, 512, 2048, 32768):
        _same(cm.prefill_cost(n_params, prompt, **HW), rm.prefill_cost(n_params, prompt, **HW))
        for chunk in (1, 256, 100000):
            _same(cm.chunked_prefill_cost(n_params, prompt, chunk, kv_token_bytes=2048.0, **HW),
                  rm.chunked_prefill_cost(n_params, prompt, chunk, kv_token_bytes=2048.0, **HW))


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_train_costs(remat):
    for b, s, d, ff, layers, vocab, chunk in [(8, 256, 3072, 8192, 28, 128256, None),
                                             (1, 4096, 16384, 53248, 126, 128256, 512)]:
        _same(cm.train_activation_bytes(b, s, d, ff, layers, vocab, remat=remat,
                                        logit_chunk=chunk),
              rm.train_activation_bytes(b, s, d, ff, layers, vocab, remat=remat,
                                        logit_chunk=chunk))
    for grad in ("all_reduce", "reduce_scatter_zero"):
        for tp, fsdp, dp, master in [(1, 1, 1, False), (4, 1, 8, True), (2, 16, 16, False)]:
            kw = dict(tp=tp, fsdp_shard=fsdp, dp=dp, grad=grad, master=master)
            _same(cm.train_memory_bytes(3.2e9, activation_bytes=1e9, **kw),
                  rm.train_memory_bytes(3.2e9, activation_bytes=1e9, **kw))
            kw = dict(chips=tp * dp * max(fsdp // dp, 1), tp=tp, dp=dp, fsdp_shard=fsdp,
                      grad=grad, batch_local=8, seq=256, d_model=3072, n_layers=28,
                      master=master, remat=remat, **HW)
            _same(cm.train_step_cost(3.2e9, 3.2e9, 2048 * dp, link=LINK, **kw),
                  rm.train_step_cost(3.2e9, 3.2e9, 2048 * dp, link=RLINK, **kw))


def test_isoefficiency():
    for p in [1, 2, 7, 64, 4096]:
        for name in ("generic", "grid", "summa", "cannon"):
            _same(getattr(cm, f"isoefficiency_matmul_{name}")(p),
                  getattr(rm, f"isoefficiency_matmul_{name}")(p))
        _same(cm.isoefficiency_floyd_warshall(p), rm.isoefficiency_floyd_warshall(p))
        for c in (1, 2, 4):
            _same(cm.isoefficiency_matmul_25d(p, c), rm.isoefficiency_matmul_25d(p, c))
        _same(cm.efficiency(10.0, 2.0, p), rm.efficiency(10.0, 2.0, p))
        _same(cm.overhead(10.0, 2.0, p), rm.overhead(10.0, 2.0, p))
    t_o = lambda w, p: math.sqrt(w) * p * 1e-3 + p
    for p in (4, 64, 1024):
        for k in (0.5, 1.0, 4.0):
            _same(cm.solve_isoefficiency(t_o, p, k), rm.solve_isoefficiency(t_o, p, k))


@pytest.mark.parametrize("n", [1024, 8192, 40000])
def test_algorithm_costs(n):
    for bpe in (2, 4):
        kw = dict(bytes_per_elt=bpe, peak_flops=rm.PEAK_FLOPS_BF16)
        for q in (1, 2, 4, 8):
            _same(cm.dns_matmul_cost(n, q, link=LINK, **kw),
                  rm.dns_matmul_cost(n, q, link=RLINK, **kw))
            _same(cm.floyd_warshall_cost(n, q, link=LINK, **kw),
                  rm.floyd_warshall_cost(n, q, link=RLINK, **kw))
            for c in (1, 2):
                if q % c == 0:
                    _same(cm.cannon_25d_cost(n, q, c, link=LINK, **kw),
                          rm.cannon_25d_cost(n, q, c, link=RLINK, **kw))
        for qx, qy in [(2, 2), (2, 4), (1, 8), (4, 8)]:
            for name in ("summa_matmul_cost", "cannon_matmul_cost", "summa_pipelined_cost"):
                _same(getattr(cm, name)(n, qx, qy, link=LINK, **kw),
                      getattr(rm, name)(n, qx, qy, link=RLINK, **kw))


# ---------------------------------------------------------------------------
# the fitted link
# ---------------------------------------------------------------------------
def test_link_terms_and_fit_recover_a_link():
    """Costs generated with a known link give back its (t_s, t_w), and
    ``link_terms`` reads the coefficients the costs are linear in."""
    true = cm.LinkClass(t_s=3e-4, t_w=1.0 / 7e9)
    runs = [lambda l: cm.dns_matmul_cost(8192, 2, link=l, peak_flops=math.inf)["total_s"],
            lambda l: cm.summa_matmul_cost(8192, 2, 4, link=l, peak_flops=math.inf)["total_s"],
            lambda l: cm.cannon_matmul_cost(8192, 2, 4, link=l, peak_flops=math.inf)["total_s"],
            lambda l: cm.summa_pipelined_cost(8192, 1, 8, link=l,
                                              peak_flops=math.inf)["total_s"]]
    terms = [cm.link_terms(f) for f in runs]
    a, b = terms[0]
    assert a == pytest.approx(2 * 1 + 1) and b == pytest.approx(3 * 4096 ** 2 * 4)
    got = cm.LinkClass.fit(terms, [f(true) for f in runs])
    assert got.t_s == pytest.approx(true.t_s, rel=1e-9)
    assert got.t_w == pytest.approx(true.t_w, rel=1e-9)
    with pytest.raises(ValueError):
        cm.LinkClass.fit([(1.0, 2.0), (2.0, 4.0)], [1.0, 2.0])   # proportional terms
    # with compute in the totals, and the pipelined SUMMA's overlap (a max)
    peak = 67e12 / 8
    totals = [lambda l, f=f: f(l, peak) for f in (
        lambda l, pk: cm.dns_matmul_cost(8192, 2, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.summa_matmul_cost(8192, 2, 4, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.summa_pipelined_cost(8192, 1, 8, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.cannon_25d_cost(8192, 2, 2, link=l, peak_flops=pk)["total_s"])]
    comms = [lambda l, f=f: f(l, math.inf) for f in (
        lambda l, pk: cm.dns_matmul_cost(8192, 2, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.summa_matmul_cost(8192, 2, 4, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.summa_pipelined_cost(8192, 1, 8, link=l, peak_flops=pk)["total_s"],
        lambda l, pk: cm.cannon_25d_cost(8192, 2, 2, link=l, peak_flops=pk)["total_s"])]
    for link in (true, cm.LinkClass(1e-6, 1.0 / 400e9)):   # comm above, below compute
        got = cm.fit_link(totals, comms, [f(link) for f in totals])
        assert got.t_s == pytest.approx(link.t_s, rel=1e-6)
        assert got.t_w == pytest.approx(link.t_w, rel=1e-6)
    with pytest.raises(ValueError):
        cm.link_terms(lambda l: cm.dns_matmul_cost(64, 2, link=l)["total_s"])  # compute left in


def test_train_prediction_for_llama_on_one_h100():
    """The numbers the trainer prints beside its measurement: 45 GB of
    state and 1.40 GB of activations; 53.2 ms of compute plus 24.9 ms of
    optimizer traffic (spec-sheet predictions, not measurements)."""
    from repro_torch import configs
    cfg = configs.get("llama3.2-3b")
    n = cfg.param_counts()["total"]
    act = cm.train_activation_bytes(8, 256, cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab)
    mem = cm.train_memory_bytes(n, param_bytes=4, grad_bytes=2, opt_state_bytes=4,
                                activation_bytes=act)
    assert mem["params"] + mem["grads"] + mem["opt"] == pytest.approx(44.98e9, rel=1e-3)
    assert act == pytest.approx(1.403e9, rel=1e-3)
    t = cm.train_step_cost(n, n, 8 * 256, chips=1, batch_local=8, seq=256,
                           d_model=cfg.d_model, n_layers=cfg.n_layers, param_bytes=4,
                           remat="full")
    assert t["compute_s"] == pytest.approx(53.2e-3, rel=1e-3)
    assert t["update_s"] == pytest.approx(24.93e-3, rel=1e-3)
    assert t["total_s"] == pytest.approx(78.2e-3, rel=1e-3)


# ---------------------------------------------------------------------------
# the reference's cost properties, on the port's H100 constants
# (tests/test_costmodel_2d.py)
# ---------------------------------------------------------------------------
PS2 = [2, 4, 8, 16, 64, 256]


@pytest.mark.parametrize("p", PS2[:-1])
def test_t_scan_and_reduce_scatter_monotone_in_p(p):
    for m in (1, 1024, 10**9):
        assert cm.t_scan(m, 2 * p) >= cm.t_scan(m, p) - 1e-15
        assert cm.t_reduce_scatter(m, 2 * p) >= cm.t_reduce_scatter(m, p) - 1e-15
        assert cm.t_reduce_scatter_ring(m, 2 * p) >= cm.t_reduce_scatter_ring(m, p) - 1e-15


@pytest.mark.parametrize("p", PS2[:-1])
def test_isoefficiency_summa_monotone_in_p(p):
    assert cm.isoefficiency_matmul_summa(2 * p) > cm.isoefficiency_matmul_summa(p)
    assert cm.isoefficiency_matmul_cannon(2 * p) > cm.isoefficiency_matmul_cannon(p)


@pytest.mark.parametrize("p", [64, 256, 1024, 4096])
def test_isoefficiency_2d_orderings(p):
    assert cm.isoefficiency_matmul_grid(p) <= cm.isoefficiency_matmul_cannon(p)
    assert cm.isoefficiency_matmul_cannon(p) <= cm.isoefficiency_matmul_summa(p)
    assert cm.isoefficiency_matmul_cannon(p) <= cm.isoefficiency_matmul_generic(p)


def test_scan_cost_shape():
    assert cm.t_scan(0, 8, cm.NVLINK) == 3 * cm.NVLINK.t_s
    assert cm.t_scan(100, 1) == 0.0
    assert cm.t_scan(100, 8, t_lambda=1e-6) > cm.t_scan(100, 8)


def test_reduce_scatter_vs_all_reduce():
    for p in PS2:
        for m in (64, 2**20, 10**9):
            assert cm.t_reduce_scatter(m, p) <= cm.t_all_reduce(m, p) + 1e-15


@pytest.mark.parametrize("n,q", [(1024, 2), (4096, 4), (40000, 8)])
def test_summa_cannon_cost_structure(n, q):
    s, c, d = cm.summa_matmul_cost(n, q), cm.cannon_matmul_cost(n, q), cm.dns_matmul_cost(n, q)
    assert s["compute_s"] == pytest.approx(c["compute_s"])
    assert s["total_s"] >= s["compute_s"] and c["total_s"] >= c["compute_s"]
    assert s["serial_s"] == pytest.approx(c["serial_s"]) == pytest.approx(d["serial_s"])
    assert c["shift_s"] <= s["broadcast_s"] * (1 + 1e-9)
    assert s["mem_elts_per_proc"] * q * q == 3 * n * n


@pytest.mark.parametrize("n,qx,qy", [(256, 2, 4), (1024, 2, 2), (1024, 2, 4),
                                     (1024, 1, 8), (4096, 2, 8), (8192, 4, 8)])
def test_summa_pipelined_leq_plain(n, qx, qy):
    s, p = cm.summa_matmul_cost(n, qx, qy), cm.summa_pipelined_cost(n, qx, qy)
    assert p["compute_s"] == pytest.approx(s["compute_s"])
    assert p["total_s"] <= s["total_s"] * (1 + 1e-9), (p, s)
    assert p["overlap_s"] == pytest.approx(
        p["comm_s"] + p["compute_s"] - max(p["comm_s"], p["compute_s"]))


@pytest.mark.parametrize("n,q,c", [(8192, 16, 4), (8192, 32, 4), (4096, 16, 4)])
def test_cannon_25d_between_cannon_and_dns(n, q, c):
    d25 = cm.cannon_25d_cost(n, q, c)
    p = d25["p"]
    q2 = round(p ** 0.5)
    assert q2 * q2 == p
    ca = cm.cannon_matmul_cost(n, q2)
    q3 = round(p ** (1 / 3))
    dns_mem = 3 * (n // q3) ** 2 if q3 ** 3 == p else None
    assert ca["mem_elts_per_proc"] < d25["mem_elts_per_proc"]
    assert d25["mem_elts_per_proc"] == 3 * c * n * n // p
    if dns_mem is not None and c < q3:
        assert d25["mem_elts_per_proc"] < dns_mem
    assert d25["comm_s"] < ca["shift_s"], (d25, ca)
    assert d25["compute_s"] == pytest.approx(ca["compute_s"])


def test_cannon_25d_tradeoff_monotone_in_c():
    n, q = 8192, 32
    costs = [cm.cannon_25d_cost(n, q, c) for c in [1, 2, 4, 8]]
    for lo, hi in zip(costs, costs[1:]):
        assert hi["comm_s"] < lo["comm_s"]
        assert hi["mem_elts_per_proc"] == lo["mem_elts_per_proc"]
    assert cm.cannon_25d_cost(n, 16, 4)["mem_elts_per_proc"] > \
        cm.cannon_matmul_cost(n, 32)["mem_elts_per_proc"]


def test_cannon_25d_c1_matches_cannon():
    d, ca = cm.cannon_25d_cost(4096, 8, 1), cm.cannon_matmul_cost(4096, 8)
    assert d["replicate_s"] == 0.0 and d["reduce_s"] == 0.0
    assert d["comm_s"] == pytest.approx(ca["shift_s"])
    assert d["total_s"] == pytest.approx(ca["total_s"])


@pytest.mark.parametrize("p", [64, 512, 4096])
def test_isoefficiency_25d_interpolates(p):
    assert cm.isoefficiency_matmul_25d(p, 1) == pytest.approx(cm.isoefficiency_matmul_cannon(p))
    c_max = round(p ** (1 / 3))
    prev = cm.isoefficiency_matmul_25d(p, 1)
    for c in (2, 4):
        if c > c_max:
            break
        cur = cm.isoefficiency_matmul_25d(p, c)
        assert cur < prev
        prev = cur
    assert cm.isoefficiency_matmul_25d(p, c_max) >= p * (1 - 1e-9)


def test_summa_cost_rectangular():
    s, c = cm.summa_matmul_cost(1024, 2, 4), cm.cannon_matmul_cost(1024, 2, 4)
    assert s["p"] == c["p"] == 8
    assert s["compute_s"] == pytest.approx(c["compute_s"])
    assert s["total_s"] > 0 and c["total_s"] > 0


def test_decode_step_cost_batch_amortizes_memory_bound():
    c1, c64 = cm.decode_step_cost(3e9, 1), cm.decode_step_cost(3e9, 64)
    assert c1["dominant"] == c64["dominant"] == "memory_s"
    assert c64["memory_s"] == pytest.approx(c1["memory_s"])
    assert c64["tok_s"] == pytest.approx(64 * c1["tok_s"])
    big = cm.decode_step_cost(3e9, 1 << 20)
    assert big["dominant"] == "compute_s"
    assert big["tok_s"] < (1 << 20) * c1["tok_s"]


def test_decode_step_cost_kv_and_overhead_terms():
    base = cm.decode_step_cost(3e9, 8)
    kv = cm.decode_step_cost(3e9, 8, kv_bytes=1e9)
    assert kv["memory_s"] > base["memory_s"] and kv["tok_s"] < base["tok_s"]
    slow = cm.decode_step_cost(3e9, 8, overhead_s=1.0)
    assert slow["total_s"] == pytest.approx(base["total_s"] + 1.0)


def test_prefill_cost_compute_bound_beats_decode_loop():
    pre = cm.prefill_cost(3e9, 2048)
    assert pre["dominant"] == "compute_s"
    assert pre["total_s"] < 2048 * cm.decode_step_cost(3e9, 1)["total_s"] / 10
    assert cm.prefill_cost(3e9, 1)["dominant"] == "memory_s"


# ---------------------------------------------------------------------------
# tests/test_properties.py's cost properties (Table 1), on H100 constants
# ---------------------------------------------------------------------------
settings.register_profile("torch_cost", max_examples=25, deadline=None)


@settings(settings.get_profile("torch_cost"))
@given(m=st.integers(1, 10**9), p=st.sampled_from([2, 4, 16, 64, 256]))
def test_reduce_cheaper_than_allgather(m, p):
    assert cm.t_reduce(m, p) <= cm.t_all_gather(m, p) + 1e-12


@settings(settings.get_profile("torch_cost"))
@given(m=st.integers(1, 10**9), p=st.sampled_from([2, 4, 16, 64]))
def test_costs_monotone_in_p(m, p):
    for fn in (cm.t_reduce, cm.t_broadcast, cm.t_all_gather, cm.t_all_to_all,
               cm.t_all_reduce, cm.t_scan, cm.t_reduce_scatter, cm.t_reduce_scatter_ring):
        assert fn(m, 2 * p) >= fn(m, p) - 1e-12


@settings(settings.get_profile("torch_cost"))
@given(m=st.integers(1, 10**9), p=st.sampled_from([2, 4, 16, 64, 256]))
def test_scan_between_shift_and_allgather(m, p):
    assert cm.t_shift(m, p) <= cm.t_scan(m, p) + 1e-12
    assert cm.t_scan(m, p) <= cm.t_all_gather(m, p) + 1e-12


@settings(settings.get_profile("torch_cost"))
@given(st.integers(64, 4096))
def test_isoefficiency_2d_between_grid_and_generic(p):
    assert cm.isoefficiency_matmul_grid(p) <= cm.isoefficiency_matmul_cannon(p)
    assert cm.isoefficiency_matmul_cannon(p) <= cm.isoefficiency_matmul_summa(p)
    assert cm.isoefficiency_matmul_cannon(p) <= cm.isoefficiency_matmul_generic(p)


@settings(settings.get_profile("torch_cost"))
@given(st.integers(2, 4096))
def test_isoefficiency_orderings(p):
    if p >= 64:
        assert cm.isoefficiency_matmul_grid(p) <= cm.isoefficiency_matmul_generic(p)


@settings(settings.get_profile("torch_cost"))
@given(flops=st.floats(1e6, 1e18), byts=st.floats(1e3, 1e15),
       coll=st.floats(0, 1e15), chips=st.sampled_from([1, 256, 512]))
def test_roofline_dominant_is_max(flops, byts, coll, chips):
    t = cm.roofline_terms(flops, byts, coll, chips)
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"], t["collective_s"])
