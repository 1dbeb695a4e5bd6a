"""CPU tests of the tiered ``gab_narrow``'s host side: the split words its
launch writes into the scratch buffer (``kernels.narrow_split_plain``)
against ``precision.split_bf16`` bit for bit, the scratch buffer, the
launch arguments of the v1 and fold forms, and the build of
``gab_narrow.cu``'s libraries in parts. No JAX and no card: the kernel's
own words are held to ``narrow_split_plain`` by the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 10 (f)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gastx_torch.models import (GastNet, GastNetConfig, init_gastnet,
                                randomize_eval_statistics)
from gastx_torch.ops.cuda import kernels as K
from gastx_torch.ops.cuda.fused_gab import KERNEL_OPS, gab_tables
from gastx_torch.ops.precision import split_bf16

WIDTHS = (16, 32, 48, 64)
FORMS = ("v1", "fold")


def _tables(c: int, form: str):
    gen = torch.Generator().manual_seed(c)
    m = GastNet(GastNetConfig(filter_widths=(3, 3), channels=c))
    m = randomize_eval_statistics(init_gastnet(m, gen), gen).eval()
    return gab_tables(m.layers_graph_conv[0], m.statics, form)


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.contiguous().view(torch.int16).numpy().astype(np.uint16)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", WIDTHS)
def test_split_words_match_split_bf16(c, form):
    """Every word of ``narrow_split_plain``: slab by slab in stream order
    (``narrow_slabs``), word (n, kp) of a slab's hi half holds the bf16
    bits of ``split_bf16(W)[0]`` at rows 2kp (low half) and 2kp + 1 (high
    half) of column n, its lo half those of ``split_bf16(W)[1]``, at the
    offsets the kernel's ring reads (``narrow_word``; the lo half C * BK
    words on); every weight of every product once."""
    t = _tables(c, form)
    off, words = K.narrow_split_plain(t)
    assert off.dtype == torch.int64 and words.dtype == torch.int32
    assert off.numel() == words.numel() == len(set(off.tolist()))
    got = dict(zip(off.tolist(), words.numpy().astype(np.uint32).tolist()))
    bk = K.NARROW_TIERED_BK[c]
    half = c * bk
    base, seen = 0, 0
    for _, w in K.narrow_slabs(t):
        hi, lo = (_bits(h) for h in split_bf16(w))
        kk, n = w.shape
        for k0 in range(0, kk, bk):
            for h, part in ((0, hi), (half, lo)):
                for kp in range(bk // 2):
                    for col in range(n):
                        word = got[base + h + K.narrow_word(col, kp, bk)]
                        assert word & 0xFFFF == part[k0 + 2 * kp, col]
                        assert word >> 16 == part[k0 + 2 * kp + 1, col]
                        seen += 1
            base += 2 * half
    assert seen == off.numel()
    assert max(got) < base <= K.NARROW_SCRATCH_WORDS - K.NARROW_SCRATCH_CTL


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", WIDTHS)
def test_narrow_slabs_are_the_products(c, form):
    """``narrow_slabs``: the block's seven products in the kernel's stream
    order (the fold form's six, without P4), each W the tables' columns
    the float32 kernel streams: P1 and P2 the sym and con semantic columns,
    P3 the local cat, P4 theta | phi, P5 g (past the fold form's 2K folded
    score columns), P6 the global cat, P7 the block concat."""
    t = _tables(c, form)
    slabs = dict(K.narrow_slabs(t))
    names = ["P1", "P2", "P3", "P5", "P6", "P7"]
    if form == "v1":
        names.insert(3, "P4")
    assert list(slabs) == names
    k = t.proj_t.shape[0]
    g0 = 4 * c + 2 * k if form == "fold" else 6 * c
    want = {"P1": t.w_proj[:, :2 * c], "P2": t.w_proj[:, 2 * c:4 * c],
            "P3": t.lcat_w, "P4": t.w_proj[:, 4 * c:6 * c],
            "P5": t.w_proj[:, g0:g0 + c], "P6": t.acat_w, "P7": t.gcat_w}
    for name, w in slabs.items():
        assert torch.equal(w, want[name])
        assert w.shape[0] % K.NARROW_TIERED_BK[c] == 0
        assert w.shape[1] in (c, 2 * c)
    assert sum(w.numel() for w in slabs.values()) == (
        16 if form == "v1" else 14) * c * c


@pytest.mark.parametrize("bk", (16, 32, 48))
def test_narrow_word_spreads_ldmatrix_rows(bk):
    """``narrow_word`` is a permutation of each column's BK / 2 words, and
    the 8 columns one ldmatrix matrix reads (any 8 consecutive from a
    multiple of 8, one 16-byte chunk of k pairs) start in 8 distinct
    groups of 4 banks: conflict-free."""
    kpw = bk // 2
    for n in range(64):
        assert sorted(K.narrow_word(n, kp, bk) - n * kpw
                      for kp in range(kpw)) == list(range(kpw))
    for n0 in range(0, 64, 8):
        for chunk in range(kpw // 4):
            groups = {K.narrow_word(n, 4 * chunk, bk) // 4 % 8
                      for n in range(n0, n0 + 8)}
            assert len(groups) == 8


def test_narrow_scratch_is_one_buffer_a_stream():
    """One zeroed int32 buffer of ``NARROW_SCRATCH_WORDS`` a (device,
    stream), made once: two launches on a stream share it, another stream
    has its own."""
    dev = torch.device("cpu")
    a = K.narrow_scratch(dev, 12345)
    assert a.dtype == torch.int32 and a.numel() == K.NARROW_SCRATCH_WORDS
    assert int(a.abs().sum()) == 0
    assert K.narrow_scratch(dev, 12345) is a
    assert K.narrow_scratch(dev, 54321) is not a


@pytest.mark.parametrize(("tier_set", "form"),
                         [(s, f) for s in ("high", "preset", "default")
                          for f in FORMS])
def test_tiered_launch_arguments(monkeypatch, tier_set, form):
    """A tiered gab_narrow call on the card launches ``gab_narrow_tiered``
    of the tiered library with the float32 call's arguments (the fold flag
    the tables' form), the seven tier codes (``narrow_tier_codes``) and the
    stream's scratch buffer with its size; counted once under its form and
    tiers. The launch is recorded with ``_lib`` patched."""
    calls = []

    class Lib:
        def __getattr__(self, symbol):
            return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(K, "_lib", lambda lib: calls.append(lib) or Lib())
    monkeypatch.setattr(K, "use_kernel", lambda device: True)
    monkeypatch.setattr(K, "_stream", lambda: 7)
    if tier_set == "preset":
        tiers = dict.fromkeys(KERNEL_OPS, "high")
        tiers.update(local_sem="default", attn_proj="kdefault",
                     attn_score="default")
    else:
        tiers = dict.fromkeys(KERNEL_OPS, tier_set)
    t = _tables(32, form)
    x = torch.zeros(3 * 17, 32)
    K.reset_launches()
    K.gab_narrow(x, t, tiers=tiers)
    K.gab_narrow(x, t)
    (lib, (symbol, args)), (lib32, (symbol32, args32)) = calls[:2], calls[2:]
    assert (lib, symbol) == ("gab_narrow_tiered", "gab_narrow_tiered")
    assert (lib32, symbol32) == ("gab_narrow", "gab_narrow")
    assert len(args) == len(K._ARGTYPES["gab_narrow_tiered"]) == 42
    assert args[2:33] == args32[2:]
    assert args[29] == 7 and args[32] == int(form == "fold")
    assert args[33:40] == tuple(K.narrow_tier_codes(tiers))
    codes = dict(zip(K.NARROW_TIER_CLASSES, args[33:40]))
    for op in K.NARROW_TIER_CLASSES[:5]:
        assert K.TC_TIERS[codes[op]] == (
            "default" if tiers[op] == "kdefault" else tiers[op])
    for op in K.NARROW_TIER_CLASSES[5:]:
        assert K.ATTN_TIERS[codes[op]] == tiers[op]
    scratch = K.narrow_scratch(x.device, 7)
    assert args[40:] == (scratch.data_ptr(), K.NARROW_SCRATCH_WORDS)
    assert K.VARIANT_LAUNCHES["gab_narrow"][form] == 2
    assert sum(K.TIER_LAUNCHES["gab_narrow"].values()) == 1
    assert all(key.startswith("fold ") == (form == "fold")
               for key in K.TIER_LAUNCHES["gab_narrow"])
    K.reset_launches()


@pytest.mark.parametrize("name", ["gab_narrow", "gab_narrow_io",
                                  "gab_narrow_tiered",
                                  "gab_narrow_tiered_io", "gemm_tc"])
def test_library_build_commands(name, monkeypatch, tmp_path):
    """gab_narrow.cu's four libraries compile in parts: one ``nvcc -c`` a
    part (``NARROW_PARTS``: the v1 instantiations with the C functions,
    and the fold ones), each with the library's flags and without
    ``-shared``, linked into the library by one ``nvcc -shared``; every
    other source compiles in one command. The parts enter the library's
    name, so a library built whole is not taken for one built in parts."""
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    source, flags = K._libraries()[name]
    tmp = tmp_path / "lib.so.tmp"
    cmds = K._compile_commands(source, flags, tmp)
    src = str(K.CSRC_DIR / f"{source}.cu")
    if source != "gab_narrow":
        assert cmds == [["nvcc", *K.NVCC_FLAGS, *flags, "-o", str(tmp),
                         src]]
        return
    assert len(cmds) == len(K.NARROW_PARTS) == 2
    objs = []
    for i, (cmd, part) in enumerate(zip(cmds, K.NARROW_PARTS)):
        assert "-shared" not in cmd and cmd[-1] == src
        assert part in cmd and "-c" in cmd
        assert all(f in cmd for f in flags)
        objs.append(cmd[cmd.index("-o") + 1])
    assert len(set(objs)) == 2
    link = K._link_command(source, tmp)
    assert "-shared" in link and link[link.index("-o") + 1] == str(tmp)
    assert link[-2:] == objs
    assert K.PART_SOURCES == {"gab_narrow": K.NARROW_PARTS}
