"""The kernel build's bookkeeping, on the CPU (nothing is compiled here):
a library's name hashes its source, every shared header and the flags, so
an edited header rebuilds every kernel; and the flash kernels, forward and
backward, share one tile loop (``flash_tile.cuh``) instead of carrying
copies of it."""

import functools
import importlib
import importlib.util
import re

import pytest

from afldm_tpu_torch import kernels
from afldm_tpu_torch.ops import filtered_act as TF


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "t.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "t.cuh").write_text("// tile loop\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_target_is_stable(csrc):
    assert kernels._target("a") == kernels._target("a")
    assert kernels._target("a") != kernels._target("b")
    assert kernels._target("a").parent == csrc / "_build"


@pytest.mark.parametrize("edit", ["t.cuh", "a.cu", "new.cuh"])
def test_header_or_source_edit_changes_target(csrc, edit):
    before = {n: kernels._target(n) for n in ("a", "b")}
    path = csrc / edit
    path.write_text((path.read_text() if path.exists() else "") + "// x\n")
    after = {n: kernels._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"]
    # a header reaches every target, a source only its own
    assert (after["b"] != before["b"]) == edit.endswith(".cuh")


def test_flags_change_target(csrc, monkeypatch):
    before = kernels._target("a")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ["-g"])
    assert kernels._target("a") != before


FLASH_SOURCES = ("flash_fwd", "flash2_fwd", "flash_probe", "flash_bwd")


@pytest.mark.parametrize("name", FLASH_SOURCES)
def test_flash_kernels_include_the_tile_loop(name):
    """Each flash source includes flash_tile.cuh and keeps no copy of its
    staging, score, softmax, p/ds or P·V loop."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    assert '#include "flash_tile.cuh"' in src
    code = re.sub(r"//[^\n]*", "", src)
    for copy in ("fmaf(", "expf(", "cp.async", "__shfl_xor_sync"):
        assert copy not in code, (name, copy)


def _dispatched(src, fn="with_dp"):
    """The D thresholds of the dispatcher ``fn`` of flash_tile.cuh, in
    order."""
    body = src[src.index(f"int {fn}(int D"):]
    body = body[:body.index("\n}\n")]
    return [int(d) for d in re.findall(r"if \(D <= (\d+)\) return f\(",
                                       body)]


def test_tile_loop_instantiates_padded_head_dims():
    """DP is D rounded up within {24, 32, 40, 64, 80, 128, 160, 256}; for
    the bf16 tile loop (``with_dp_mma``, ``MmaCfg``) D rounded up to a
    multiple of 16 within {32, 48, 64, 80, 128, 160, 256}."""
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    dps = [int(d) for d in re.findall(r"struct FlashCfg<(\d+)>", src)]
    assert dps == [24, 32, 40, 64, 80, 128, 160, 256]
    assert _dispatched(src) == dps
    assert _dispatched(src, "with_dp_mma") == [32, 48, 64, 80, 128, 160,
                                                256]


def test_backward_configures_every_padded_head_dim():
    """Every DP that ``with_dp`` dispatches has a backward tiling
    (``BwdCfg``), and both backward kernels dispatch through ``with_dp``
    onto it."""
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    dispatched = _dispatched(src)
    cfgs = [int(d) for d in re.findall(r"struct BwdCfg<(\d+)> : Cfg<", src)]
    assert cfgs == dispatched
    bwd = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_bwd.cu").read_text())
    for cfg in ("DqCfg", "DkvCfg"):
        assert f"{cfg}<BwdCfg<decltype(dp)::value>>" in bwd, cfg
    assert bwd.count("with_dp(D,") == 2
    for absent in ("atomic", "wmma", "mma.sync", "tf32"):
        assert absent not in bwd.lower(), absent


def _fwd_cfgs(src):
    """{DP: BK} of the bf16 forward tile loop's table (FwdCfg)."""
    return {int(dp): int(bk) for dp, bk in re.findall(
        r"struct FwdCfg<(\d+)> : FwdMma<\1, (\d+)>", src)}


def test_q_tile_matches_the_tile_loop():
    """``flash_probes.q_tile`` (the sweep's recorded Q tile) is the BQ of
    each FlashCfg: (threads / column groups) row groups of 4 rows; at bf16
    FwdCfg's and MmaCfg's 16 rows a warp."""
    import torch
    from afldm_tpu_torch.ops.flash_probes import q_tile
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    cfgs = re.findall(
        r"struct FlashCfg<(\d+)> : Cfg<\d+, (\d+), (\d+), \d+>", src)
    assert len(cfgs) == 8
    for dp, threads, tc in cfgs:
        assert q_tile(int(dp)) == int(threads) // int(tc) * 4, dp
    for cfg in ("struct FwdMma {", "struct MmaCfg {"):
        body = src[src.index(cfg):]
        warps = int(re.search(r"kWarps = (\d+);", body).group(1))
        assert "BQ = 16 * kWarps;" in body
        for d in (8, 80, 256):
            assert q_tile(d, torch.bfloat16) == 16 * warps, (cfg, d)


def test_bf16_key_tile_matches_the_tile_loop():
    """``ops.attention.flash_bf16_key_tile`` (the plain versions' tile) is
    FwdCfg's BK at every instantiated DP and every D padded to it, and the
    table covers exactly the DPs ``with_dp_mma`` dispatches."""
    from afldm_tpu_torch.ops.attention import flash_bf16_key_tile
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    table = _fwd_cfgs(src)
    assert sorted(table) == _dispatched(src, "with_dp_mma")
    for d in range(1, 257):
        dp = min(p for p in table if p >= d)
        assert flash_bf16_key_tile(d) == table[dp], d


@pytest.mark.parametrize("where", ["root", "elsewhere"])
@pytest.mark.parametrize("script,argv", [("phase_check", ["main_path"]),
                                         ("phase_check", ["vae_train"]),
                                         ("phase_check", ["video_edit"]),
                                         ("phase_check", ["normal"]),
                                         ("plane_sweep", []),
                                         ("plane_sweep", ["--bwd"])])
def test_measurement_scripts_need_a_checkout_and_a_card(
        script, argv, where, tmp_path, monkeypatch, capsys):
    """phase_check.py and plane_sweep.py, like kernel_check.py, refuse
    outside a checkout's root and, here, for want of a card."""
    mod = importlib.import_module(f"afldm_tpu_torch.scripts.{script}")
    root = kernels.CSRC.parents[2]
    monkeypatch.chdir(root if where == "root" else tmp_path)
    monkeypatch.setattr(mod.sys, "path", list(mod.sys.path))
    assert mod.main(argv) == 1
    err = capsys.readouterr().err
    assert ("no CUDA device" if where == "root" else "root of a checkout") \
        in err


@pytest.mark.parametrize("where", ["root", "elsewhere"])
def test_kernel_check_needs_a_checkout_and_a_card(where, tmp_path,
                                                  monkeypatch, capsys):
    """kernel_check.py refuses outside a checkout's root and, here, for
    want of a card: it never times on the CPU."""
    from afldm_tpu_torch.scripts import kernel_check
    root = kernels.CSRC.parents[2]
    monkeypatch.chdir(root if where == "root" else tmp_path)
    monkeypatch.setattr(kernel_check.sys, "path", list(kernel_check.sys.path))
    assert kernel_check.main(["flash_fwd"]) == 1
    err = capsys.readouterr().err
    assert ("no CUDA device" if where == "root" else "root of a checkout") \
        in err


def _kernel_body(src, name):
    """The text of ``__global__`` kernel (or function) ``name`` up to the
    next kernel, struct, template or entry point, comments removed."""
    code = re.sub(r"//[^\n]*", "", src)
    start = code.index(f"{name}(")
    end = min(i for i in (code.find("__global__", start),
                          code.find('extern "C"', start),
                          code.find("\nstruct ", start),
                          code.find("\ntemplate ", start)) if i > 0)
    return code[start:end]


def test_plane_kernel_on_the_filtered_tile():
    """K5 runs its four products and K5b its six through filtered_tile.cuh
    (every operand staged in shared memory with 16-byte cp.async; K5b's
    act′ ⊙ product in the epilogue that reads C); block_gemm is gone from
    the file; K1 is four and K2 six launches of the tiled GEMM of
    filtered_gemm.cuh (K1's chain in ``banded_f32``, K2's in
    ``banded_bwd_f32``, which serve a float32 and a bfloat16 x), with no
    kernel of their own. None of these f32
    kernels uses tensor cores (no wmma, mma.sync, wgmma or TF32): the bf16
    variants of the reduced precision levels do, through filtered_mma.cuh
    alone (test_level_variants_on_the_mma_routine). bf16 appears in
    filtered_tile.cuh only as a storage type of x and out (its load4 and
    store4), never in the f32 kernels' bodies."""
    src = (kernels.CSRC / "filtered_act.cu").read_text()
    assert '#include "filtered_tile.cuh"' in src
    assert '#include "filtered_gemm.cuh"' in src
    assert "block_gemm" not in src
    k5 = _kernel_body(src, "filtered_act_plane_kernel")
    assert k5.count("product(") == 4 and "stage(" in k5
    assert "cp_async16(" in k5
    k5b = _kernel_body(src, "filtered_act_plane_bwd_kernel")
    assert k5b.count("product(") == 6 and "stage(" in k5b
    assert "cp_async16(" in k5b and k5b.count("MulActGrad{") == 1
    code = re.sub(r"//[^\n]*", "", src)
    assert "filtered_act_banded_kernel" not in code
    assert "filtered_act_banded_bwd_kernel" not in code
    k1 = _kernel_body(src, "banded_f32")
    assert "<<<" not in k1
    assert k1.count("filtered_gemm<") == 4
    k2 = _kernel_body(src, "banded_bwd_f32")
    assert "<<<" not in k2
    assert k2.count("filtered_gemm<") == 6
    assert k2.count("MulActGrad{") == 1
    tile, gemm = (re.sub(r"//[^\n]*", "", (kernels.CSRC / f).read_text())
                  for f in ("filtered_tile.cuh", "filtered_gemm.cuh"))
    assert "cp.async.cg.shared.global" in tile and "float4" in tile
    assert "kReadsC" in tile
    assert "cp.async.cg.shared.global" in gemm and "float4" in gemm
    assert "fmaf(" in gemm and "__syncthreads" in gemm
    gemm_f32 = gemm[gemm.index("filtered_gemm_kernel"):
                    gemm.index("filtered_gemm_mma_kernel")]
    f32_code = k5 + k5b + k1 + k2
    for absent in ("wmma", "mma.sync", "mma_", "ldmatrix", "tf32", "wgmma"):
        assert absent not in (tile + gemm_f32 + f32_code).lower(), absent
    assert "bfloat16" not in (gemm_f32 + f32_code).lower()


def test_level_variants_on_the_mma_routine():
    """The reduced levels' variants run on filtered_mma.cuh (ldmatrix
    fragments, mma.sync m16n8k16 bf16, 1 or 3 passes). K5 and K5b are
    persistent walks in their own source, filtered_plane_mma.cu. K5: the
    operators staged once, the next group's x in flight by cp.async, t =
    U_h·x and out = D_h·t₂ by strips, and the middle pair fused (hi =
    act(t·U_wᵀ) in registers, t₂ = hi·D_wᵀ), so its layout
    (MmaPlaneLayout) holds no 2W × 2H buffer. K5b: the next group's x and
    g in flight by cp.async, the operators staged once (resident) or a
    phase at a time; t = U_h·x and v = D_hᵀ·g by strips into shared
    memory, the backward middle pair (pre = t·U_wᵀ and ds = v·D_w, m =
    act′(pre) ⊙ ds in registers as the A fragment of s = m·U_w, s over t)
    and dx = U_hᵀ·s by strips, so its layout (MmaPlaneBwdLayout) holds no
    2W × 2H buffer either; no 16×16 warp-tile walk is left. K1 is two
    launches of its own source,
    filtered_banded_mma.cu: the up kernel's two products (t = U_h·x split
    into shared memory, then hi = act(t·U_wᵀ) to the scratch as bf16
    pieces) and the down kernel's two (lo = D_h·hi into shared memory, then
    out = lo·D_wᵀ), the operators and hi by cp.async, so no t and no lo
    reach device memory and the GEMM is not used. K2 is two launches of the
    same source: the backward up kernel's four products (t = U_h·x and v =
    D_hᵀ·g split into shared strips, then act′(t·U_wᵀ) ⊙ (v·D_w) to the
    scratch as m's bf16 pieces) and K1's down kernel on m (s = U_hᵀ·m into
    shared memory, then dx = s·U_w), so no t, v, pre or s reach device
    memory and no f32 scratch is used; no TF32 and no wgmma anywhere."""
    src = (kernels.CSRC / "filtered_act.cu").read_text()
    plane_src = (kernels.CSRC / "filtered_plane_mma.cu").read_text()
    assert '#include "filtered_mma.cuh"' in plane_src
    k5 = _kernel_body(plane_src, "filtered_act_plane_mma_kernel")
    assert k5.count("strip_product<") == 2 and k5.count("middle_pair<") == 1
    assert "mma_product" not in k5 and "split_planes<" in k5
    assert k5.count("stage_blob(") == 4 and "for (; g < groups" in k5
    assert "gridDim.x" in k5 and "stage_planes(" in k5
    plane_code = re.sub(r"//[^\n]*", "", plane_src)
    for struct in ("MmaPlaneLayout", "MmaPlaneBwdLayout"):
        layout = plane_code[plane_code.index(f"struct {struct} {{"):]
        layout = layout[:layout.index("};")]
        assert "2 * W, 2 * H" not in layout and "2 * H, 2 * W" not in layout
        assert "passes" in layout and "x_bytes" in layout
    mma_h = re.sub(r"//[^\n]*", "", (kernels.CSRC / "filtered_mma.cuh")
                   .read_text())
    pair = mma_h[mma_h.index("void middle_pair("):]
    pair = pair[:pair.index("\n}\n")]
    assert pair.count("strip_step<") == 2 and "act.map(v)" in pair
    assert "ldsm_x4(th[k]" in pair and "store_strip<" in pair
    # K5b's middle pair: pre and ds over the strip's t and v fragments, m =
    # act′(pre) ⊙ ds in registers, split into the A fragment of s's step,
    # s stored once over t
    pair = mma_h[mma_h.index("void middle_pair_bwd("):]
    pair = pair[:pair.index("\n}\n")]
    assert pair.count("strip_step<") == 3 and "grad.grads(m)" in pair
    assert "m[e] = m[e] * dv[e]" in pair and "split2(m[2 * r]" in pair
    assert pair.count("store_strip<") == 1 and "store_strip<PASSES>(t," in pair
    for absent in ("warp_tile", "mma_product", "stage_split", "mma_buf"):
        assert absent not in mma_h, absent
    k5b = _kernel_body(plane_src, "filtered_act_plane_bwd_mma_kernel")
    assert k5b.count("strip_product<") == 3
    assert k5b.count("middle_pair_bwd<") == 1 and "MulActGrad{act}" in k5b
    assert k5b.count("split_planes<") == 2
    assert "for (; (long long)q * ppi < nplanes; q += gridDim.x)" in k5b
    assert "gridDim.x" in k5b and k5b.count("stage_planes(") == 2
    # the six operators staged once (resident) or a phase at a time
    assert k5b.count("stage_blob(") == 12
    assert k5b.count("store_strip<PASSES>(") == 2
    assert "ToPlanes<T>{o, H, W, HW}" in k5b
    code = re.sub(r"//[^\n]*", "", src)
    for gone in ("filtered_act_plane_mma_kernel",
                 "filtered_act_plane_bwd_mma_kernel", "MmaPlaneLayout",
                 "MmaPlaneBwdLayout", "plane_bf16(", "plane_bwd_bf16(",
                 "banded_bf16("):
        assert gone not in code, gone
    k1_src = (kernels.CSRC / "filtered_banded_mma.cu").read_text()
    k1_code = re.sub(r"//[^\n]*", "", k1_src)
    assert '#include "filtered_mma.cuh"' in k1_src
    assert "filtered_gemm" not in k1_code and "float* scratch" not in k1_code
    level = _kernel_body(k1_src, "banded_level")
    assert level.count("<<<") == 1 and level.count("down<PASSES,") == 2
    assert _kernel_body(k1_src, "down").count("<<<") == 1
    assert k1_code.count("<<<") == 3 and k1_code.count("__global__") == 3
    up = _kernel_body(k1_src, "banded_up_kernel")
    down = _kernel_body(k1_src, "banded_down_kernel")
    # each launch: a product with A's k-major slabs (the up launch's x
    # split one slab ahead), then one with A from its strip
    assert up.count("k_loop<C, PASSES, true, true>(") == 1
    assert down.count("k_loop<C, PASSES, true, false>(") == 1
    for k in (up, down):
        assert k.count("k_loop<C, PASSES, false, false>(") == 1
        assert k.count("slab_async<") >= 2
    assert "raw_async<C::kThreads, T," in up
    assert "split_raw<C::kThreads, PASSES, T," in up
    # t and lo go only into the shared strip; hi and out to device memory,
    # through a tile in the ring
    for k in (up, down):
        assert k.count("store_pair<PASSES>(strip") == 1
    assert up.count("store_pair<PASSES>(tile") == 1 and "act.map(v)" in up
    assert "hp + pc * lo" in up and "op + (long long)row * W" in down
    assert "store2(q" in down
    assert "add_two_sum(" in k1_code and "cp.async.cg.shared.global" in \
        k1_code
    # K2: two launches a chunk, the backward up launch and K1's down
    # launch on U_h's and U_w's blobs, and no six-GEMM chain left
    assert "banded_bwd_bf16(" not in re.sub(r"//[^\n]*", "", src)
    bwd_level = _kernel_body(k1_src, "banded_bwd_level")
    assert "<<<" not in bwd_level
    assert bwd_level.count("bwd_up<PASSES,") == 2
    assert bwd_level.count("down<PASSES,") == 2
    assert "(ms, dx, uh, uw," in bwd_level
    bwd_launch = _kernel_body(k1_src, "bwd_up")
    assert bwd_launch.count("<<<") == 1 and "MulActGrad{act}" in bwd_launch
    k2 = _kernel_body(k1_src, "banded_bwd_up_kernel")
    # t's and v's strips: one product with A's k-major slabs, x and g split
    # one slab ahead; then pre and ds, each with A from its strip
    assert k2.count("k_loop<C, PASSES, true, true>(") == 1
    assert k2.count("k_loop<C, PASSES, false, false>(") == 1
    assert k2.count("across(ts") == 2
    assert "raw_async<C::kThreads, T," in k2
    assert "split_raw<C::kThreads, PASSES, T," in k2
    # t and v go only into the shared strips; m to device memory, through a
    # tile in the ring, once, as act′(pre) (in place of pre's sums) times ds
    assert k2.count("store_pair<PASSES>(strip") == 1
    assert k2.count("store_pair<PASSES>(tile") == 1
    assert k2.count("mp + pc * lo") == 1 and "grad.grads(ag)" in k2
    assert "m[k] = ag[k] * m[k]" in k2
    for absent in ("float*", "filtered_gemm", "store2(", "op + "):
        assert absent not in k2, absent
    mma = re.sub(r"//[^\n]*", "", (kernels.CSRC / "filtered_mma.cuh")
                 .read_text())
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in mma
    assert "__floats2bfloat162_rn" in mma and "PASSES == 3" in mma
    gemm = re.sub(r"//[^\n]*", "", (kernels.CSRC / "filtered_gemm.cuh")
                  .read_text())
    assert "mma_bf16(" in gemm[gemm.index("filtered_gemm_mma_kernel"):]
    for absent in ("tf32", "wgmma"):
        assert absent not in (mma + gemm + code + plane_code
                              + k1_code).lower(), absent


def _entry_points(src):
    """{name: number of parameters} of the ``extern "C"`` functions of a
    source, comments removed."""
    code = re.sub(r"//[^\n]*", "", src)
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', code):
        out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


@pytest.mark.parametrize("name", kernels.SOURCES)
def test_entry_points_match_their_ctypes_signatures(name):
    """Every C entry of a source has a ctypes signature of its own number
    of arguments, and every signature names an entry: a missing or extra
    argument would pass pointers as ints, or shift every argument."""
    entries = _entry_points((kernels.CSRC / f"{name}.cu").read_text())
    sigs = kernels._SIGNATURES[name]
    assert set(entries) == set(sigs)
    for fn, n in entries.items():
        assert len(sigs[fn]) == n, fn


def test_every_bf16_variant_has_launch_counts():
    """One counter per bf16-activation variant, beside the one of the
    variant it shadows, and an entry of its own in the sources."""
    for k in kernels.BF16_KERNELS:
        assert k in kernels.LAUNCHES and f"{k}/bf16" in kernels.LAUNCHES
    entries = {**_entry_points((kernels.CSRC / "filtered_act.cu")
                               .read_text()),
               **_entry_points((kernels.CSRC / "filtered_plane_mma.cu")
                               .read_text()),
               **_entry_points((kernels.CSRC / "filtered_banded_mma.cu")
                               .read_text()),
               **_entry_points((kernels.CSRC / "flash_fwd.cu").read_text()),
               **_entry_points((kernels.CSRC / "flash2_fwd.cu").read_text())}
    for name in ("filtered_act_plane_f32_xbf16",
                 "filtered_act_plane_bf16_xbf16",
                 "filtered_act_banded_f32_xbf16",
                 "filtered_act_banded_bf16_xbf16", "flash_fwd_bf16",
                 "flash2_fwd_bf16"):
        assert name in entries, name


def test_flash_bf16_kernels_on_the_mma_tile_loop():
    """K3's and K6's bf16 kernels run flash_tile.cuh's bf16 forward tile
    loop (fwd_walk: the scores and P·V on mma.sync bf16, V through
    ldmatrix.trans, P from the score registers) with the online softmax,
    K6's once a K/V set over one staged Q tile, P1's with the identity;
    all dispatch D through with_dp_mma onto FwdCfg; no wgmma, no TF32."""
    tile = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_tile.cuh")
                  .read_text())
    walk = _kernel_body(tile, "fwd_walk")
    assert walk.count("mma_scores<C>(") == 1
    assert "body.update(" in walk and "ldsm_x4_t(" in walk
    assert "mma_attend" not in tile and "mma_pv_pass" not in tile
    for name, n, body in (("flash_fwd", 1, "OnlineSoftmax<C>"),
                          ("flash2_fwd", 2, "OnlineSoftmax<C>"),
                          ("flash_probe", 1, "IdentityP<C>")):
        src = re.sub(r"//[^\n]*", "", (kernels.CSRC / f"{name}.cu")
                     .read_text())
        kname = ("probe_dots_bf16_kernel" if name == "flash_probe"
                 else f"{name}_bf16_kernel")
        k = _kernel_body(src, kname)
        assert k.count("fwd_walk<C>(") == n and body in k, name
        assert ("FwdCfg<" if name == "flash_probe" else "with_fwd_cfg<") \
            in src, name
        for absent in ("wgmma", "tf32"):
            assert absent not in src.lower(), absent
    for name in ("flash_fwd", "flash2_fwd"):
        src = re.sub(r"//[^\n]*", "", (kernels.CSRC / f"{name}.cu")
                     .read_text())
        assert src.count("with_dp_mma(D,") == 1


def test_bf16_forward_walks_k_once():
    """The bf16 forward's only staging of K and V is fwd_walk's ring: one
    loop over the key tiles a set, each tile staged once (K_j and V_j in
    one stage) and one barrier a tile; the online softmax takes its row
    max, sum and rescale inside that loop (no statistics pass)."""
    tile = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_tile.cuh")
                  .read_text())
    walk = _kernel_body(tile, "fwd_walk")
    assert walk.count("for (int j = 0; j < n; ++j)") == 1
    assert walk.count("stage_rows_bf16<C, C::BK>(") == 2  # K_j and V_j
    assert walk.count("__syncthreads()") == 2  # a tile's, and the exit's
    update = _kernel_body(tile[tile.index("struct OnlineSoftmax"):], "update")
    assert "ex2_approx(fmaf(" in update and "expf(" not in update
    for name in ("flash_fwd", "flash2_fwd", "flash_probe"):
        src = re.sub(r"//[^\n]*", "", (kernels.CSRC / f"{name}.cu")
                     .read_text())
        k = _kernel_body(src, "probe_dots_bf16_kernel" if name ==
                         "flash_probe" else f"{name}_bf16_kernel")
        # Q is the kernel's only staging; K and V come through fwd_walk
        assert k.count("stage_rows_bf16<") == 1 and "for (" not in \
            k.split("fwd_walk<C>(")[0], name


def test_every_level_variant_has_launch_counts():
    """One counter per kernel and reduced level, beside the f32 kernel's,
    and an entry of its own for each in the sources: K5's and K5b's in
    filtered_plane_mma.cu, K1's and K2's in filtered_banded_mma.cu, the
    GEMM's in filtered_act.cu."""
    entries = {src: _entry_points((kernels.CSRC / f"{src}.cu").read_text())
               for src in ("filtered_act", "filtered_plane_mma",
                           "filtered_banded_mma")}
    for k in kernels.LEVEL_KERNELS:
        assert k in kernels.LAUNCHES
        for level in ("high", "default"):
            assert f"{k}:{level}" in kernels.LAUNCHES
        src = ("filtered_banded_mma" if k.startswith("filtered_act_banded")
               else "filtered_plane_mma" if k.startswith("filtered_act_plane")
               else "filtered_act")
        assert f"{k}_bf16" in entries[src], k


def test_filtered_tile_edit_rebuilds_filtered_act(tmp_path, monkeypatch):
    """filtered_tile.cuh is one of the headers hashed into every library
    name: editing it rebuilds filtered_act."""
    for f in kernels.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels._target("filtered_act")
    with open(tmp_path / "filtered_tile.cuh", "a") as f:
        f.write("// edit\n")
    assert kernels._target("filtered_act") != before


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py, loaded once a process (its users only read it)."""
    path = kernels.CSRC.parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_logs_launch_plans():
    """chip_smoke's log suffix at every kernel shape: K5's, K5b's, K1's and
    K2's plans (K5b's with six micro-tiles, K2's with six tiles a chunk),
    nothing for the other kernels."""
    smoke = _chip_smoke()
    for name, spec in smoke.KERNELS.items():
        for shape in spec["shapes"]:
            plan = smoke.launch_plan(name, shape)
            if name in ("filtered_act_plane", "filtered_act_plane_bwd",
                        "filtered_act_banded", "filtered_act_banded_bwd"):
                assert plan.startswith("; plan "), (name, shape)
            else:
                assert plan == "", (name, shape)
    for name in ("filtered_act_banded", "filtered_act_banded_bwd"):
        assert "2 chunks of 8 planes" in smoke.launch_plan(
            name, (1, 16, 1024, 1024))
    assert "(8 planes: 128 128 128 128 128 128)" in smoke.launch_plan(
        "filtered_act_banded_bwd", (1, 16, 1024, 1024))
    plan = TF.plane_bwd_plan(64, 64, 2048)
    assert smoke.launch_plan("filtered_act_plane_bwd", (4, 512, 64, 64)) == (
        f"; plan P 1, tiles {' '.join(f'{r}x{c}' for r, c in plan.tiles)}, "
        f"{plan.threads} threads, smem {TF.plane_bwd_smem_bytes(64, 64, 1)} B")
    assert len(plan.tiles) == 6


@pytest.mark.parametrize("level", ["high", "default"])
def test_chip_smoke_logs_k1_level_plan_and_floor(level):
    """Phase 30's K1 lines: the fused chain's plan (chunks, planes a
    chunk, each launch's strips and shared bytes, the hi pieces' scratch
    and its cap) at each KERNELS shape up to LEVEL_MAX, and K1:high's
    TwoSum floor, counted over its own four products: K5's for a square
    plane, apart from it for a mixed one (K1 decimates H first)."""
    smoke = _chip_smoke()
    for shape in smoke.KERNELS["filtered_act_banded"]["shapes"]:
        n, c, h, w = shape
        if max(h, w) > TF.LEVEL_MAX:
            continue
        plan = TF.banded_mma_plan(h, w, n * c, level, TF.BANDED_HI_BYTES)
        per = max(ch.planes for ch in plan)
        line = smoke.level_launch_plan("filtered_act_banded", shape, level)
        assert line.startswith(f"; plan {len(plan)} chunks of <= {per} ")
        assert f"hi scratch {TF.banded_mma_scratch_bytes(h, w, per, level)}" \
            in line and f"(cap {TF.BANDED_HI_BYTES} B)" in line
        assert f"up {-(-2 * h // 64)} strips of 64 rows" in line
    assert smoke.level_launch_plan(
        "filtered_act_banded_bwd", (4, 128, 128, 128), level).startswith(
            "; plan 1 chunks of <= 512 planes, up 4 strips of 64 rows")
    square = (2, 3, 96, 96)
    assert smoke.twosum_floor_ms(square, "filtered_act_banded") == \
        smoke.twosum_floor_ms(square)
    mixed = (1, 64, 32, 128)
    assert smoke.twosum_floor_ms(mixed, "filtered_act_banded") != \
        smoke.twosum_floor_ms(mixed)
    floor = sum(smoke.twosum_floor_ms(s, "filtered_act_banded")
                for s in smoke.KERNELS["filtered_act_banded"]["shapes"][:5])
    assert 5.4 < floor < 5.5


@pytest.mark.parametrize("level", ["high", "default"])
def test_chip_smoke_logs_k2_level_plan_and_floor(level):
    """Phase 30's K2 lines: the fused chain's plan (chunks, planes a
    chunk, the up launch's strips of the 2H side and the down launch's of
    the H side with each block's shared bytes, the m pieces' scratch and
    its cap) at each KERNELS shape up to LEVEL_MAX, and K2:high's TwoSum
    floor over its six products, 18·S³ multiply-adds a square plane, which
    is 1.5 times K1:high's 12·S³."""
    smoke = _chip_smoke()
    for shape in smoke.KERNELS["filtered_act_banded_bwd"]["shapes"]:
        n, c, h, w = shape
        if max(h, w) > TF.LEVEL_MAX:
            continue
        plan = TF.banded_mma_plan(h, w, n * c, level, TF.BANDED_HI_BYTES,
                                  True)
        per = max(ch.planes for ch in plan)
        up, down = plan[0].tiles
        line = smoke.level_launch_plan("filtered_act_banded_bwd", shape,
                                       level)
        assert line.startswith(f"; plan {len(plan)} chunks of <= {per} ")
        assert f"up {-(-2 * h // up)} strips of {up} rows a plane (" \
            f"{TF.banded_mma_smem_bytes(w, level, up, False, strips=2)} B)" \
            in line
        assert f"down {-(-h // down)} of {down} (" \
            f"{TF.banded_mma_smem_bytes(w, level, down, True)} B)" in line
        assert f"m scratch {TF.banded_mma_scratch_bytes(h, w, per, level)}" \
            in line and f"(cap {TF.BANDED_HI_BYTES} B)" in line
    for shape in ((2, 3, 96, 96), (1, 2, 128, 128)):
        k1 = smoke.twosum_floor_ms(shape, "filtered_act_banded")
        k2 = smoke.twosum_floor_ms(shape, "filtered_act_banded_bwd")
        assert abs(k2 / k1 - 1.5) < 1e-12
    mixed = (1, 64, 32, 128)
    assert smoke.twosum_floor_ms(mixed, "filtered_act_banded_bwd") != \
        1.5 * smoke.twosum_floor_ms(mixed, "filtered_act_banded")


@pytest.mark.parametrize("level", ["high", "default"])
def test_chip_smoke_logs_k5b_level_plan_and_floor(level):
    """Phase 30's K5b lines: the persistent walk's plan (grid, blocks an
    SM, planes an iteration, resident or phased operators, shared bytes)
    at each KERNELS shape, K5b:high's TwoSum floor over its six products,
    18·S³ multiply-adds a square plane, 1.5 times K5:high's 12·S³, and
    K5b:default's byte floor, x and g read and dx written once."""
    smoke = _chip_smoke()
    for shape in smoke.KERNELS["filtered_act_plane_bwd"]["shapes"]:
        n, c, h, w = shape
        plan = TF.plane_mma_bwd_plan(h, w, n * c, level)
        assert smoke.level_launch_plan("filtered_act_plane_bwd", shape,
                                       level) == (
            f"; plan grid {plan.grid} ({plan.per_sm} an SM), P "
            f"{plan.planes} an iteration, operators "
            f"{'resident' if plan.resident else 'phased'}, smem "
            f"{plan.smem_bytes} B")
    for shape in ((4, 512, 64, 64), (16, 192, 32, 32), (1, 3, 48, 48)):
        k5 = smoke.twosum_floor_ms(shape)
        k5b = smoke.twosum_floor_ms(shape, "filtered_act_plane_bwd")
        assert abs(k5b / k5 - 1.5) < 1e-12
    assert smoke.byte_floor_ms((4, 512, 64, 64)) == \
        1e3 * 12 * 4 * 512 * 64 * 64 / smoke.PEAK_BYTES
    assert smoke.LEVEL_SOURCES["filtered_act_plane_bwd"].endswith(
        "kernels/csrc/filtered_plane_mma.cu")


def test_chip_smoke_names_each_kernels_registers():
    """Each register or spill line of a build log goes with the kernel
    whose entry function ptxas compiled last."""
    smoke = _chip_smoke()
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Compiling entry function 'bar' for 'sm_90a'",
        "ptxas info    : Used 72 registers"])
    lines = smoke.ptxas_lines(log)
    assert [line for _, line in lines] == [
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        "ptxas info    : Used 72 registers"]
    names = [fn for fn, _ in lines]
    assert names[0] == names[1] != names[2] == "bar"
    assert names[0] in ("foo", "_Z3fooPf")  # demangled where c++filt is


@pytest.mark.parametrize("hw", [(32, 128), (128, 32), (68, 92), (80, 80),
                                (4, 4848)])
def test_filtered_act_bounds_count_the_cheaper_order(hw):
    """chip_smoke's bounds charge each filter pair the cheaper of its two
    orders: 24·S³ (forward) and 36·S³ (backward) FLOP a square plane, the
    same for a plane and its transpose, and never more than K1's and K2's
    chains do (12H²W + 12HW² and 20H²W + 16HW², their order fixed)."""
    smoke = _chip_smoke()
    H, W = hw
    fwd, _ = smoke.filtered_act_work((1, 2, H, W))
    bwd, _ = smoke.filtered_act_bwd_work((1, 2, H, W))
    assert fwd == smoke.filtered_act_work((1, 2, W, H))[0]
    assert 3 * fwd == 2 * bwd
    chain = sum(2 * m * n * k * b for m, n, k, b in
                TF.banded_products(H, W, 2))
    assert chain == 2 * (12 * H * H * W + 12 * H * W * W)
    assert fwd <= chain and (fwd < chain) == (H != W)
    bwd_chain = sum(2 * m * n * k * b for m, n, k, b in
                    TF.banded_bwd_products(H, W, 2))
    assert bwd_chain == 2 * (20 * H * H * W + 16 * H * W * W)
    assert bwd <= bwd_chain and (bwd < bwd_chain) == (H != W)
    if H == W:
        assert fwd == 2 * 24 * H ** 3


@pytest.mark.parametrize("name,group", [
    ("void afldm_filtered::filtered_gemm_kernel<128, 128, true, "
     "(anonymous namespace)::MulActGrad>(afldm_filtered::GemmArgs)",
     "port kernels"),
    ("void (anonymous namespace)::filtered_act_plane_bwd_kernel<512>(float "
     "const*, float const*, float*, float const*, float const*, float "
     "const*, float const*, float const*, float const*, int, int, int, int, "
     "int, int)", "port kernels"),
    ("void flash_fwd_kernel<64>(FlashArgs)", "port kernels"),
    ("void (anonymous namespace)::banded_bwd_up_kernel<3, 64, float>(float "
     "const*, float const*, __nv_bfloat16*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, int, "
     "int, long long, afldm_filtered::MulActGrad)", "port kernels"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3",
     "GEMM"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize32x64x8",
     "FFT and complex GEMM"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw",
     "convolution")])
def test_profile_groups_kernel_names(name, group):
    """The device-time breakdown counts the banded chains' GEMM launches
    (K1, K2) with the port's kernels, not with cuBLAS's GEMMs."""
    from afldm_tpu_torch.scripts import profile_main_path
    assert profile_main_path.group_of(name) == group


BF16_BWD_ENTRIES = {
    "filtered_act": ("filtered_act_plane_bwd_f32_xbf16",
                     "filtered_act_banded_bwd_f32_xbf16"),
    "filtered_plane_mma": ("filtered_act_plane_bwd_bf16_xbf16",),
    "filtered_banded_mma": ("filtered_act_banded_bwd_bf16_xbf16",),
    "flash_bwd": ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}


@pytest.mark.parametrize("source,name", [
    (src, n) for src, names in BF16_BWD_ENTRIES.items() for n in names])
def test_bf16_backward_entries_match_their_twins(source, name):
    """The six backward entries of bf16 training: each in its source with
    a ctypes signature equal to its float32 twin's (the same arguments, x,
    g and dx or q, k, v, dO and the gradients bf16), and launch counters
    for the bf16 variant beside the twin's."""
    entries = _entry_points((kernels.CSRC / f"{source}.cu").read_text())
    twin = (name.replace("_xbf16", "") if name.endswith("_xbf16")
            else name.replace("_bf16", "_f32"))
    assert name in entries and twin in entries
    sigs = kernels._SIGNATURES[source]
    assert sigs[name] == sigs[twin] and len(sigs[name]) == entries[name]
    base = name.split("_f32")[0].split("_bf16")[0]
    assert f"{base}/bf16" in kernels.LAUNCHES
    if source != "flash_bwd":
        for level in ("high", "default"):
            assert f"{base}:{level}/bf16" in kernels.LAUNCHES


@pytest.mark.parametrize("name", ["flash_probe_dots_bf16",
                                  "flash_probe_stream_bf16"])
def test_bf16_probe_entries_match_their_twins(name):
    """P1's and P2's bf16 entries: in flash_probe.cu with bf16 q, k, v and
    out, a ctypes signature equal to the f32 twin's, a launch counter
    beside the twin's, and the bf16 tile loop's staging (P1 also the bf16
    forward's walk, fwd_walk); no library call inside."""
    src = (kernels.CSRC / "flash_probe.cu").read_text()
    entries = _entry_points(src)
    twin = name.replace("_bf16", "_f32")
    assert name in entries and twin in entries
    sigs = kernels._SIGNATURES["flash_probe"]
    assert sigs[name] == sigs[twin] and len(sigs[name]) == entries[name]
    base = name[:-len("_bf16")]
    assert base in kernels.LAUNCHES and f"{base}/bf16" in kernels.LAUNCHES
    code = re.sub(r"//[^\n]*", "", src)
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', code).group(1)
    assert [p.split("*")[0].split()[-1] for p in params.split(",")[:4]] == [
        "bf16"] * 4
    for piece in ("stage_rows_bf16", "launch_mma_tiles", "fwd_walk<C>("):
        assert piece in code, piece
    for absent in ("cublas", "torch", "wgmma"):
        assert absent not in code.lower(), absent


def test_flash_bwd_bf16_kernels_on_the_mma_tile_loop():
    """K4a's and K4b's bf16 kernels run flash_tile.cuh's bf16 backward:
    the fixed rows' A fragments through FixedA, the walked tiles through
    bwd_walk's ring, 16 walked rows at a time, both score tiles through
    chunk_scores and the second products through chunk_walked
    (ldmatrix.trans), p by bwd_p_exp2, dispatched through with_bwd_mma at
    every padded head dim; no wgmma, no TF32, no atomics."""
    tile = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_tile.cuh")
                  .read_text())
    for piece in ("struct BwdMmaCfg", "int with_bwd_mma(", "struct FixedA",
                  "void bwd_walk(", "void chunk_scores(",
                  "void chunk_walked(", "inline int dkv_splits(",
                  "__floats2bfloat162_rn"):
        assert piece in tile, piece
    src = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_bwd.cu")
                 .read_text())
    dq = _kernel_body(src, "flash_bwd_dq_bf16_kernel")
    dkv = _kernel_body(src, "flash_bwd_dkv_bf16_kernel")
    for k, walked in ((dq, 1), (dkv, 2)):
        assert k.count("bwd_walk<C>(") == 1
        assert k.count("chunk_scores<C>(") == 2
        assert k.count("chunk_walked<C>(") == walked
        assert "bwd_p_exp2(" in k and "FixedA<C>" in k
        assert "mma_scores<C>(" not in k
    assert src.count("with_bwd_mma<") == 2
    for absent in ("wgmma", "tf32", "atomic"):
        assert absent not in src.lower(), absent


def _bwd_tiles(src):
    """{DP: BK} of the bf16 backward's table (BwdTile)."""
    return {int(dp): int(bk) for dp, bk in re.findall(
        r"struct BwdTile<(\d+)> : BwdTileOf<(\d+)>", src)}


def test_bwd_walk_tile_matches_the_tile_loop():
    """``ops.attention.flash_bwd_bf16_walk_tile`` is BwdTile's BK at every
    instantiated DP and every D padded to it; the table covers exactly the
    DPs ``with_dp_mma`` dispatches; 64 or 128 rows."""
    from afldm_tpu_torch.ops.attention import flash_bwd_bf16_walk_tile
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    table = _bwd_tiles(src)
    assert sorted(table) == _dispatched(src, "with_dp_mma")
    for d in range(1, 257):
        dp = min(p for p in table if p >= d)
        assert flash_bwd_bf16_walk_tile(d) == table[dp], d
    assert set(table.values()) <= {64, 128}
    with pytest.raises(ValueError):
        flash_bwd_bf16_walk_tile(257)


def _cxx_dkv_splits(src):
    """flash_tile.cuh's dkv_splits as a Python function of (bh, Lq, Lk, BQ,
    BK), translated statement by statement from its source: integer
    division, the ternary as a conditional expression."""
    body = src[src.index("inline int dkv_splits("):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:
                                         body.index("\n}\n")])
    lines = []
    for stmt in (t.strip() for t in body.split(";") if t.strip()):
        stmt = re.sub(r"\bconst long long\b|\(int\)", "", stmt)
        stmt = stmt.replace("C::", "").replace("/", "//")
        stmt = re.sub(r"(\w[^=?]*?) \? ([^:]+) : (.+)", r"(\2 if \1 else \3)",
                      stmt)
        stmt = re.sub(r"^if \((.*)\) return", r"if \1: return", stmt)
        lines.append("    " + stmt.replace("||", "or").strip())
    env = {}
    exec("def f(bh, Lq, Lk, BQ, BK, kSplitSMs):\n" + "\n".join(lines), env)
    return env["f"]


def test_dkv_split_plan_matches_the_tile_loop():
    """``ops.attention.flash_bwd_dkv_splits`` (the wrapper's workspace) is
    flash_tile.cuh's dkv_splits, with BwdMmaCfg's 64 fixed rows, BwdTile's
    walked tile and kSplitSMs, over B·H, Lq, Lk and D around its edges;
    the SD trainers' cross-attention over 77 text tokens splits."""
    from afldm_tpu_torch.ops import attention as A
    src = (kernels.CSRC / "flash_tile.cuh").read_text()
    cxx = _cxx_dkv_splits(src)
    sms = int(re.search(r"constexpr int kSplitSMs = (\d+);", src).group(1))
    cfg = src[src.index("struct BwdMmaCfg {"):]
    bq = int(re.search(r"int BQ = (\d+);", cfg).group(1))
    table = _bwd_tiles(src)
    assert (A._SPLIT_SMS, A._BWD_FIXED_ROWS) == (sms, bq)
    for d in (8, 24, 40, 64, 80, 100, 160, 256):
        bk = table[min(p for p in table if p >= d)]
        for bh in (1, 2, 8, 16, 33, 66, 131, 132, 512):
            for lq in (1, 64, 129, 256, 511, 1000, 1024, 4096, 9000):
                for lk in (4, 64, 77, 130, 1024):
                    assert A.flash_bwd_dkv_splits(bh, lq, lk, d) == cxx(
                        bh, lq, lk, bq, bk, sms), (bh, lq, lk, d)
    assert A.flash_bwd_dkv_splits(8, 4096, 77, 40) == 16
    assert A.flash_bwd_dkv_splits(16 * 8, 1024, 1024, 24) == 1


def test_bf16_backward_has_no_expf():
    """The bf16 backward's p is ex2.approx with the scale folded into one
    FFMA (bwd_p_exp2): no expf in its kernels or in the bf16 backward's
    part of flash_tile.cuh; the f32 kernels keep bwd_p's expf."""
    tile = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_tile.cuh")
                  .read_text())
    bf16_part = tile[tile.index("struct BwdTileOf"):]
    assert "expf(" not in bf16_part
    p2 = _kernel_body(tile, "bwd_p_exp2")
    assert "fmaf(s, scale, -lse)" in p2 and "ex2_approx(" in p2
    assert "expf(" in _kernel_body(tile, "bwd_p")
    src = re.sub(r"//[^\n]*", "", (kernels.CSRC / "flash_bwd.cu")
                 .read_text())
    for name in ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel"):
        assert "expf(" not in _kernel_body(src, name), name


def test_dkv_reduce_entry_has_argtypes():
    """The split K4b's reduction: an entry in flash_bwd.cu with ctypes
    argtypes of its own arity (the partials and dk/dv as pointers, the
    element count 64-bit, the split count an int), beside the split
    entry's; a launch counter of its own."""
    entries = _entry_points((kernels.CSRC / "flash_bwd.cu").read_text())
    sigs = kernels._SIGNATURES["flash_bwd"]
    for name in ("flash_bwd_dkv_reduce", "flash_bwd_dkv_bf16_split"):
        assert name in entries and len(sigs[name]) == entries[name], name
    import ctypes
    assert sigs["flash_bwd_dkv_reduce"] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    twin = sigs["flash_bwd_dkv_bf16"]
    split = sigs["flash_bwd_dkv_bf16_split"]
    # dk and dv give way to the partials; the split count after the scale
    assert split == twin[:6] + twin[7:-1] + [ctypes.c_int, ctypes.c_void_p]
    assert "flash_bwd_dkv_reduce" in kernels.LAUNCHES


def test_dkv_reduce_plain_sums_in_split_order():
    """On the CPU ``flash_bwd_dkv_reduce`` is its plain version: the f32
    partials summed in split order and rounded once to bf16 (bit for bit
    the sequential sum), (2, ...) from (splits, 2, ...)."""
    import numpy as np
    import torch
    from afldm_tpu_torch.ops import attention as A
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.standard_normal((5, 2, 1, 3, 77, 40))
                          .astype(np.float32))
    got = A.flash_bwd_dkv_reduce(ws)
    acc = ws[0].numpy().copy()
    for s in range(1, 5):
        acc = (acc + ws[s].numpy()).astype(np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 3, 77, 40)
    assert torch.equal(got, torch.from_numpy(acc).to(torch.bfloat16))
    assert torch.equal(A.flash_bwd_dkv_reduce(ws[:1]), ws[0].to(
        torch.bfloat16))
