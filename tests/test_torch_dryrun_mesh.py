"""PyTorch port: the meshed dry run (``launch.dryrun --mesh single``) on a
``"fake"`` process group, on the CPU, at reduced configs.

A meshed cell is rank 0's step on meta tensors: its shards, its rows, its
cache, and collectives that move nothing but are counted by the
reference's kinds as result bytes. Held exactly, on small meshes:

* **FLOPs** (on (2, 2)): rank 0's equal the unmeshed cell's products with
  every sharded dim divided by its shard count and every other dim whole:
  the unmeshed cell of the config whose q heads, kv heads, MLP width and
  vocabulary are divided by the model extent where they divide it (kept
  whole where they do not), at the batch divided by the data extent. Decode
  and prefill in kernel mode (prepared) and exact mode, the train step in
  exact mode, for reduced olmo-1b (heads and kv heads split alike) and a
  reduced qwen3-8b with 6 q / 3 kv heads, whose kv heads replicate.
* **Collective bytes by kind** (on (1, 2)) equal what the partition specs
  imply: the vocab-sharded embedding's sum and the logits' gather, the
  row-parallel ``wo`` and ``down`` sums (int32 in kernel mode), and in
  training the backward's sums where a whole activation (or K and V, where
  they replicate) enters a rank's heads or columns, the recompute's ``wo``
  sums (remat stops before ``down``'s) and the gradient norm's.

Also: ``--mesh multi`` is refused by name (ROADMAP Queue 1 item 3), a
process that already has a process group is refused; a full-width meshed
cell's record carries the reference's keys, ``topcolls`` and ``reanalyze``
read its saved trace and ``roofline`` its record (``--rank-table``); after
an FSDP gather, a hybrid group's stacked integer banks are K-major again.
"""
import dataclasses
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun, reanalyze, roofline, topcolls  # noqa: E402
from test_torch_mamba2 import one_torch_thread  # noqa: E402,F401

SHAPES = {"decode": ShapeConfig("decode", 48, 4, "decode"),
          "prefill": ShapeConfig("prefill", 24, 2, "prefill"),
          "train": ShapeConfig("train", 16, 4, "train")}


def _cfgs():
    olmo = reduced(get_config("olmo-1b"))
    qwen = dataclasses.replace(reduced(get_config("qwen3-8b")), num_heads=6, num_kv_heads=3,
                               d_ff=256)
    return {"olmo-1b": olmo, "qwen3-8b-6q3kv": qwen}


CFGS = _cfgs()
# (cell kind, mode, prepared)
CELLS = (("decode", "kernel", True), ("decode", "exact", False), ("prefill", "kernel", True),
         ("prefill", "exact", False), ("train", "exact", False))


def _costs(cfg, shape, mode, prepared, mesh_shape=None):
    """The analyzer's costs of one cell, unmeshed or as rank 0 of a fake
    mesh of ``mesh_shape``."""
    if mesh_shape is None:
        step, args = dryrun.build_cell("", "", mode, prepared=prepared, cfg=cfg, shape=shape)
        return cost_analysis.analyze(step, *args)[0].costs()
    with dryrun.fake_mesh(mesh_shape) as mesh:
        step, args = dryrun.build_cell("", "", mode, prepared=prepared, mesh=mesh, cfg=cfg,
                                       shape=shape)
        return cost_analysis.analyze(step, *args)[0].costs()


def _divided(cfg, shape, mesh_shape):
    """The config and shape of the unmeshed cell that does rank 0's
    products: the model-sharded dims divided, the batch over data."""
    d, m = mesh_shape

    def div(n):
        return n // m if n % m == 0 else n

    cfg = dataclasses.replace(cfg, num_heads=div(cfg.num_heads),
                              num_kv_heads=div(cfg.num_kv_heads), d_ff=div(cfg.d_ff),
                              vocab_size=div(cfg.vocab_size))
    rows = shape.global_batch // d if shape.global_batch % d == 0 else shape.global_batch
    return cfg, dataclasses.replace(shape, global_batch=rows)


@pytest.mark.parametrize("kind,mode,prepared", CELLS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_rank_flops_are_the_divided_products(name, kind, mode, prepared):
    """On (2, 2), rank 0's FLOPs equal those of the unmeshed cell whose
    model-sharded dims are divided by 2 and whose batch is halved; the
    unmeshed cell's own FLOPs are 2-4x larger (module docstring)."""
    cfg, shape = CFGS[name], SHAPES[kind]
    got = _costs(cfg, shape, mode, prepared, (2, 2))
    want = _costs(*_divided(cfg, shape, (2, 2)), mode, prepared)
    assert got.dot_flops == want.dot_flops > 0

    def attention(c):  # the row-parallel dots run kernel 1's split form instead
        return {k: n for k, n in c.kernels.items() if "attention" in k}

    assert attention(got) == attention(want)
    whole = _costs(cfg, shape, mode, prepared)
    assert 2 * got.dot_flops < whole.dot_flops <= 4 * got.dot_flops
    assert got.collective_bytes > 0 and whole.collective_bytes == 0


def _expected_collectives(cfg, kind, mode, m):
    """The result bytes by kind that the partition specs imply for one cell
    on (1, m), every dim of these configs dividing m but the kv heads of the
    replicating one (module docstring)."""
    shape = SHAPES[kind]
    n = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    act = n * cfg.d_model * 4  # one (rows, d_model) activation, f32 or int32
    layers = cfg.num_layers
    reduce = act * (1 + 2 * layers)  # the embedding's sum; wo and down a layer
    gather = n * cfg.vocab_size * 4  # the logits
    if kind != "train":
        return {"all-reduce": float(reduce), "all-gather": float(gather)}
    kv_whole = cfg.num_kv_heads % m != 0
    kv_act = n * cfg.num_kv_heads * cfg.head_dim * 4
    # backward: the attention's and the MLP's entries a layer (and K's and
    # V's where they replicate; q_norm's), the lm_head's entry
    entries = layers * (2 * act + (2 * kv_act if kv_whole else 0)
                        + (cfg.head_dim * 4 if cfg.qk_norm else 0)) + act
    recompute = layers * act  # remat recomputes each layer up to wo's sum
    norm = 4  # the gradient norm's sum of squares over the model ranks
    return {"all-reduce": float(reduce + entries + recompute + norm),
            "all-gather": float(gather)}


@pytest.mark.parametrize("kind,mode,prepared", CELLS)
@pytest.mark.parametrize("name", sorted(CFGS))
def test_collective_bytes_are_what_the_specs_imply(name, kind, mode, prepared):
    cfg = CFGS[name]
    got = _costs(cfg, SHAPES[kind], mode, prepared, (1, 2))
    want = _expected_collectives(cfg, kind, mode, 2)
    assert got.collective_by_kind == want
    assert got.collective_bytes == sum(want.values())


def test_multi_refused_by_name_and_no_second_group():
    with pytest.raises(ValueError, match="Queue 1 item 3"):
        dryrun.run_cell("olmo-1b", "decode_32k", mesh_kind="multi")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "olmo-1b", "--mesh", "multi"])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                                rank=0, world_size=1)
        try:
            with pytest.raises(RuntimeError, match="process group"):
                with dryrun.fake_mesh((1, 2)):
                    pass
        finally:
            dist.destroy_process_group()
    assert not dist.is_initialized()


def test_meshed_cell_record_and_its_trace(tmp_path):
    """A full-width cell on the 16x16 mesh: olmo-1b decode_32k in kernel
    mode, prepared. Its record has the reference's keys; rank 0 holds 8 of
    the 128 rows, a sixteenth of the heads and of the vocabulary; its
    collectives are read back by ``topcolls`` and summed again by
    ``reanalyze``."""
    rec = dryrun.run_cell("olmo-1b", "decode_32k", mesh_kind="single", mode="kernel",
                          out_dir=str(tmp_path), prepared=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert not dist.is_initialized()  # the fake group is torn down
    for key in ("flops_dev", "hbm_bytes_dev", "hbm_bytes_upper_dev", "coll_bytes_dev",
                "coll_by_kind", "memory", "fits_one_card"):
        assert key in rec
    assert rec["mesh_shape"] == {"data": 16, "model": 16} and rec["rank"] == 0
    cfg = get_config("olmo-1b")
    # the GQA kernel on a rank's 8 slots and one of its 16 kv heads (as it is
    # costed): the cache rows it reads, once
    cache = 2 * cfg.num_layers * 8 * 32768 * (cfg.num_kv_heads // 16) * cfg.head_dim * 4
    assert rec["hbm_bytes_dev"] >= cache and rec["fits_one_card"] is True
    assert set(rec["coll_by_kind"]) == {"all-reduce", "all-gather"}
    header, records = cost_analysis.load_trace(
        str(tmp_path / "ops" / (dryrun.stem(rec) + ".jsonl.gz")))
    top, total = topcolls.top_collectives(records, 5)
    assert total == rec["coll_bytes_dev"] and len(top) == 5
    assert top[0][0] == max(r["coll_bytes"] for r in records if r.get("coll"))
    path = tmp_path / (dryrun.stem(rec) + ".json")
    with open(path) as f:
        saved = json.load(f)
    saved["coll_bytes_dev"] = 0.0
    with open(path, "w") as f:
        json.dump(saved, f)
    assert reanalyze.reanalyze(str(path))
    with open(path) as f:
        assert json.load(f) == rec
    # the roofline reads it as one of 256 ranks; the rank table renders it
    assert roofline.terms(rec)["flops_global"] == 256 * rec["flops_dev"]
    table = roofline.render_rank_table(roofline.load_records(str(tmp_path), "single", "kernel",
                                                             "prepared"))
    row = next(line for line in table.splitlines() if line.startswith("| olmo-1b |"))
    assert f"kernel: {rec['flops_dev'] / 1e12:.4g} TF" in row and "fits" in row


@pytest.mark.parametrize("mode", ["kernel", "int8"])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_fsdp_gather_keeps_stacked_banks_k_major(kind, mode):
    """Reduced zamba2-7b on (2, 1), prepared: its hybrid groups' Mamba2
    layers are banks with a stacked axis, FSDP-sharded over ``data`` and
    gathered a group at a time (``collectives.gather_data``). The gathered
    banks are K-major again, layer by layer, which the fused and MAC
    wrappers check on meta as on the card; rank 0's FLOPs are the half
    batch's."""
    cfg, shape = reduced(get_config("zamba2-7b")), SHAPES[kind]
    got = _costs(cfg, shape, mode, True, (2, 1))
    assert got.dot_flops == _costs(*_divided(cfg, shape, (2, 1)), mode, True).dot_flops > 0
    assert got.collective_by_kind["all-gather"] > 0
