"""The orbax directories the JAX package writes (OCDBT, zstd-compressed
zarr chunks), read by the port with neither JAX, orbax, tensorstore nor a
zstd package: ``native/zstd_decoder.cc`` through ``utils/zstd.py``,
``utils/ocdbt.py`` and ``utils/orbax.py``.

Trees come from the JAX package's own init and its ``save_checkpoint(...,
fmt="orbax")``; the oracles are the JAX package's ``load_checkpoint``
(orbax's restore), tensorstore's ``ocdbt`` kvstore and ``ocdbt.dump``, and
tensorstore's zarr arrays for compressed chunks. Every comparison of
arrays and bytes is exact. The entry points (``main --test``,
``transcribe``, ``decode.lm_path``) are held to the same weights carried
across as a torch checkpoint (``utils/weights.py``,
``utils/torch_ckpt.py``), and ``main --load`` to the JAX package's solver
resuming from the same directory. The decoder is built with ``g++`` at first use,
as the FLAC decoder's tests build theirs."""
import copy
import json
import struct
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from end_to_end_asr_pytorch_tpu.models.asr import ASR as JaxASR  # noqa: E402
from end_to_end_asr_pytorch_tpu.models.lm import RNNLM as JaxLM  # noqa: E402
from end_to_end_asr_pytorch_tpu.models.plugin import \
    EmbeddingRegularizer as JaxPlugin  # noqa: E402
from end_to_end_asr_pytorch_tpu.utils.checkpoint import (  # noqa: E402
    load_checkpoint as jax_load, save_checkpoint as jax_save)
from end_to_end_asr_pytorch_tpu_torch import main as port_main  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch import train, transcribe  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.asr import ASR  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.lm import RNNLM  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.models.plugin import \
    EmbeddingRegularizer  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.solvers import test_asr  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils import (  # noqa: E402
    jax_ckpt, native, ocdbt, orbax, torch_ckpt, zstd)
from end_to_end_asr_pytorch_tpu_torch.utils.tensorboard import \
    crc32c  # noqa: E402
from end_to_end_asr_pytorch_tpu_torch.utils.weights import (  # noqa: E402
    _to_port_layout, asr_from_arrays, lm_from_arrays, load_plugin_arrays,
    port_name)
from tests.torch_port_fixtures import jax_arrays  # noqa: E402

torch.set_num_threads(1)
LAS = yaml.safe_load((ROOT / "config/synthetic/las.yaml").read_text())
LM_YAML = yaml.safe_load((ROOT / "config/synthetic/lm.yaml").read_text())
V = 31
FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax_las"


def _gru(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"]["module"] = cfg["decoder"]["module"] = "GRU"
    return cfg


def _jax_tree(case, tmp_path, seed=3):
    """(the JAX tree, its model config, a function building fresh port
    modules for it: (model, plugin or None))."""
    key = jax.random.PRNGKey(seed)
    if case.startswith("lm"):
        cfg = {**LM_YAML["model"], "emb_tying": case == "lm_tied"}
        jp = JaxLM(V, cfg).init(key)
        return jp, cfg, lambda: (RNNLM(V, cfg, device="cpu"), None)
    cfg = _gru(LAS["model"]) if case == "gru" else LAS["model"]
    jp = JaxASR(40, V, cfg).init(key)
    if case != "plugin":
        return jp, cfg, lambda: (ASR(40, V, cfg, device="cpu"), None)
    np.save(tmp_path / "emb.npy",
            np.random.RandomState(seed).randn(V, 16).astype(np.float32))
    pcfg = {"src": str(tmp_path / "emb.npy"), "weight": 0.5, "fuse": 0.3}
    jpp = JaxPlugin(pcfg, V, 128).init(jax.random.PRNGKey(seed + 1))
    return {"asr": jp, "plugin": jpp}, cfg, lambda: (
        ASR(40, V, cfg, device="cpu"),
        EmbeddingRegularizer(pcfg, V, 128, device="cpu"))


def _zeros(tree):
    return jax.tree.map(lambda x: x * 0, tree)


def _by_port_name(tree):
    return {port_name(k): v for k, v in jax_arrays(tree).items()}


def _assert_same(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (what, k)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", ["las", "gru", "lm", "lm_tied", "plugin"])
def test_jax_written_directories_read_bit_for_bit(tmp_path, case):
    """``save_checkpoint(fmt="orbax")`` of the JAX package: an OCDBT
    directory, zstd chunks; the port's ``read_orbax`` gives every leaf of
    the JAX tree, equal to what the JAX package's ``load_checkpoint``
    restores, and ``load_checkpoint`` fills the port's modules as the
    weight bridge does."""
    jp, cfg, build = _jax_tree(case, tmp_path)
    path = tmp_path / "best.pth"
    jax_save(str(path), jp, None, 42, {"wer": 0.5}, fmt="orbax")
    assert (path / "model" / "manifest.ocdbt").is_file()
    ck = orbax.read_orbax(path)
    assert ck["global_step"] == 42 and ck["metrics"] == {"wer": 0.5}
    assert ck["optimizer"] is None
    _assert_same(ck["model"], _by_port_name(jp), "JAX tree")
    restored = jax_load(str(path), _zeros(jp))["model"]
    _assert_same(ck["model"], _by_port_name(restored), "JAX restore")

    model, plugin = build()
    out = jax_ckpt.load_checkpoint(str(path), model, plugin)
    assert out["format"] == "orbax" and out["global_step"] == 42
    arrays = jax_arrays(jp)
    if case == "plugin":
        ref = asr_from_arrays(40, V, cfg, {
            k[len("['asr']"):]: v for k, v in arrays.items()
            if k.startswith("['asr']")}, "cpu")
        ref_plugin = EmbeddingRegularizer(
            {"src": str(tmp_path / "emb.npy")}, V, 128, device="cpu")
        load_plugin_arrays(ref_plugin, {
            k[len("['plugin']."):]: v for k, v in arrays.items()
            if k.startswith("['plugin']")})
        for k, v in ref_plugin.state_dict().items():
            assert torch.equal(plugin.state_dict()[k], v), k
    elif case.startswith("lm"):
        ref = lm_from_arrays(V, cfg, arrays, "cpu")
    else:
        ref = asr_from_arrays(40, V, cfg, arrays, "cpu")
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def _tree(seed=0):
    """A tree with a leaf orbax splits (24,000 f32 with a 20 KB chunk
    size), a bf16 leaf, a scalar and an int leaf."""
    rng = np.random.RandomState(seed)
    return {"big": jnp.asarray(rng.randn(300, 80).astype(np.float32)),
            "half": jnp.asarray(rng.randn(5, 7).astype(np.float32)
                                ).astype(jnp.bfloat16),
            "scalar": jnp.asarray(np.float32(3.25)),
            "count": jnp.arange(9, dtype=jnp.int32)}


def _orbax_save(path, tree, use_ocdbt, use_zarr3):
    args = jax.tree.map(lambda x: ocp.SaveArgs(chunk_byte_size=20000)
                        if x.size > 1000 else ocp.SaveArgs(), tree)
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
            use_ocdbt=use_ocdbt, use_zarr3=use_zarr3)) as c:
        c.save(path, args=ocp.args.PyTreeSave(tree, save_args=args))


def _orbax_restore(path):
    with ocp.PyTreeCheckpointer() as c:
        return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(
                    c.restore(path))}


def _assert_leaves(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype.name == "bfloat16":     # read as float32, exactly
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(
                got[k].view(np.uint32) >> 16, w.view(np.uint16), str(k))
            assert not (got[k].view(np.uint32) & 0xFFFF).any()
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, str(k))


LAYOUTS = {"ocdbt": True, "dirs": False}


def _big_chunks(path, layout):
    """The chunk shape orbax chose for the tree's ``big`` leaf, and the
    chunk keys present in the store."""
    if LAYOUTS[layout]:
        store = ocdbt.read_ocdbt(path)
        meta = store[b"big/.zarray"]
        keys = [k for k in store if k.startswith(b"big/")
                and not k.endswith(b".zarray")]
    else:
        meta = (path / "big" / ".zarray").read_bytes()
        keys = [p for p in (path / "big").iterdir() if p.name[0].isdigit()]
    return json.loads(meta)["chunks"], keys


@pytest.mark.parametrize("layout", LAYOUTS)
def test_orbax_layouts_read_as_orbax_restores_them(tmp_path, layout):
    """OCDBT or a directory a leaf, zarr v2 (``.zarray``, ``0.0``, zstd): a
    leaf split into several chunks, bf16, a scalar, int32."""
    path = tmp_path / "item"
    _orbax_save(path, _tree(), LAYOUTS[layout], False)
    got, _ = orbax.read_item(path)
    _assert_leaves(got, _orbax_restore(path))
    (r, c), keys = _big_chunks(path, layout)
    assert len(keys) == -(-300 // r) * -(-80 // c) > 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_zarr3_leaves_raise_naming_zarr_v3(tmp_path, layout):
    """orbax's ``use_zarr3`` layout, which the JAX package never sets, is
    refused by name rather than misread."""
    path = tmp_path / "item"
    _orbax_save(path, _tree(), LAYOUTS[layout], True)
    with pytest.raises(NotImplementedError, match="zarr v3"):
        orbax.read_item(path)


def test_missing_chunks_take_the_fill_value(tmp_path):
    """Chunks absent from the store read as the fill value (zarr v2's
    null: zeros), as tensorstore's zarr arrays read them (orbax's restore
    refuses a missing chunk)."""
    path = tmp_path / "item"
    _orbax_save(path, _tree(1), False, False)
    (r, c), _ = _big_chunks(path, "dirs")
    (path / "big/2.0").unlink()
    got, _ = orbax.read_item(path)
    want = ts.open({"driver": "zarr",
                    "kvstore": f"file://{path}/big/"}).result().read().result()
    big = got[("big",)]
    np.testing.assert_array_equal(big, want)
    assert not big[2 * r:3 * r, :c].any() and big[:2 * r].all()


@pytest.mark.parametrize("separator,dtype", [(".", "<f4"), ("/", ">f4")])
def test_zarr2_separators_and_byte_orders(tmp_path, separator, dtype):
    """A zarr v2 array that tensorstore writes with a zstd compressor,
    ``0.0`` or ``0/0`` chunk keys, either byte order, ragged edge chunks
    and one chunk never written."""
    data = np.random.RandomState(7).randn(50, 30).astype(np.float32)
    arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/a/",
                   "metadata": {
                       "shape": [50, 30], "chunks": [16, 16], "dtype": dtype,
                       "dimension_separator": separator,
                       "compressor": {"id": "zstd", "level": 5},
                       "fill_value": None}}, create=True).result()
    arr[:32].write(data[:32]).result()
    arr[32:, :16].write(data[32:, :16]).result()

    def get(key):
        p = tmp_path / key
        return p.read_bytes() if p.is_file() else None

    got = orbax.read_array(get, "a", "a")
    want = arr.read().result()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[32:, 16:].any()
    assert (tmp_path / f"a/0{separator}1").is_file()


def test_a_leaf_orbax_splits_in_a_jax_checkpoint_is_read_whole(
        tmp_path, monkeypatch):
    """The JAX package's own save with orbax's target data-file size cut
    to 64 KB: orbax splits every leaf above it (the encoder's 512-column
    matrices) into chunks; each is read back whole."""
    from orbax.checkpoint._src.serialization import tensorstore_utils
    monkeypatch.setattr(tensorstore_utils,
                        "_DEFAULT_OCDBT_TARGET_DATA_FILE_SIZE", 64 * 1024)
    jp = JaxASR(40, V, LAS["model"]).init(jax.random.PRNGKey(5))
    jax_save(str(tmp_path / "split.pth"), jp, None, 1, fmt="orbax")
    keys = ocdbt.read_ocdbt(tmp_path / "split.pth" / "model")
    split = [k for k in keys if k.startswith(b"encoder.layers.0.fwd.w_hh/")
             and not k.endswith(b".zarray")]
    assert len(split) > 1
    _assert_same(orbax.read_orbax(tmp_path / "split.pth")["model"],
                 _by_port_name(jp))


def _ts_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _multi_level_store(root, compression):
    """A tensorstore OCDBT database of 4 commits of 30 keys with 256-byte
    nodes (a B+tree several levels deep), values inline up to 16 bytes
    and indirect above, and 2-way version tree nodes; its nodes compressed
    as ``compression`` says (None: not compressed)."""
    config = {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 16,
              "version_tree_arity_log2": 1, "compression": compression}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    rng = np.random.RandomState(0)
    for c in range(4):
        with ts.Transaction() as txn:
            for i in range(30):
                kv.with_transaction(txn).write(
                    f"k{c}/item{i:03d}".encode(),
                    rng.bytes(int(rng.randint(1, 60)))).result()
    return root


@pytest.mark.parametrize("store", ["jax_model", "jax_process_0", "jax_lm",
                                   "multi_level", "uncompressed"])
def test_ocdbt_lists_what_tensorstore_lists(tmp_path, store):
    """Every key and value of the database, as tensorstore's ``ocdbt``
    kvstore lists and reads them; each prefix gives the keys under it."""
    if store.startswith("jax"):
        jp = (JaxLM(V, LM_YAML["model"]) if store == "jax_lm"
              else JaxASR(40, V, LAS["model"])).init(jax.random.PRNGKey(2))
        jax_save(str(tmp_path / "j.pth"), jp, None, 0, fmt="orbax")
        root = tmp_path / "j.pth" / "model"
        if store == "jax_process_0":
            root = root / "ocdbt.process_0"
    else:
        root = _multi_level_store(tmp_path / "db", {"id": "zstd"}
                                  if store == "multi_level" else None)
    want = _ts_items(root)
    db = ocdbt.Database(root)
    got = dict(db.items())
    assert list(got) == sorted(want) and got == want
    for prefix in {k[:n] for k in list(want)[::7] for n in (1, 3, 9)}:
        assert dict(db.items(prefix)) == {
            k: v for k, v in want.items() if k.startswith(prefix)}
    assert dict(db.items(b"\xff")) == {}


def test_ocdbt_reads_a_deep_tree_and_its_version_tree(tmp_path):
    """A B+tree several levels deep and versions spread over version tree
    nodes: every generation ``ocdbt.dump`` lists, the newest root's
    location, and the manifest's config."""
    root = _multi_level_store(tmp_path / "db", {"id": "zstd", "level": 5})
    base = ts.KvStore.open(f"file://{root}/").result()
    dump = ts.ocdbt.dump(base).result()
    db = ocdbt.Database(root)
    m = db.manifest
    assert m.compression == {"id": "zstd", "level": 5}
    assert (m.max_decoded_node_bytes, m.max_inline_value_bytes,
            m.version_tree_arity_log2) == (256, 16, 1)
    assert dump["version_tree_nodes"], "no version tree node to read"
    new = dump["versions"][-1]
    latest = db.latest()
    assert latest.root_height == new["root_height"] >= 2
    assert (f"btreenode::{latest.root.path}:{latest.root.offset}:"
            f"{latest.root.length}") == new["root"]["location"]
    assert latest.num_keys == new["root"]["statistics"]["num_keys"] == 120
    gens = [v.generation for v in db.versions()]
    assert gens == list(range(1, new["generation_number"] + 1))
    assert [r.generation for r in m.version_nodes] == [
        n["generation_number"] for n in dump["version_tree_nodes"]]
    assert dict(db.items()) == _ts_items(root)


def _reframe(region: bytes, body: bytes, version=0, compression=0):
    """A manifest region around ``body`` with a fresh length and CRC."""
    head = region[:4]
    n = 4 + 8 + 2 + len(body) + 4
    out = head + struct.pack("<Q", n) + bytes([version, compression]) + body
    return out + struct.pack("<I", crc32c(out))


@pytest.mark.parametrize("fault", ["crc", "format_version", "compression",
                                   "numbered_manifest", "truncated",
                                   "escaping_path"])
def test_ocdbt_refuses_what_it_does_not_read(tmp_path, fault):
    root = _multi_level_store(tmp_path / "db", None)
    path = root / "manifest.ocdbt"
    region = path.read_bytes()
    assert region[13] == 0          # an uncompressed manifest
    body = region[14:-4]
    if fault == "crc":
        bad = bytearray(region)
        bad[20] ^= 1
        err, match = ValueError, "CRC-32C mismatch"
    elif fault == "format_version":
        bad = _reframe(region, body, version=1)
        err, match = NotImplementedError, "format version 1"
    elif fault == "compression":
        bad = _reframe(region, body, compression=2)
        err, match = NotImplementedError, "compression format 2"
    elif fault == "numbered_manifest":
        bad = _reframe(region, body[:16] + b"\x01" + body[17:])
        err, match = NotImplementedError, "manifest_kind 1"
    elif fault == "truncated":
        bad = _reframe(region, body[:-3])
        err, match = ValueError, "truncated"
    else:                        # a data file "d/<hex>" made "../<hex>"
        at = body.index(b"d/")
        bad = _reframe(region, body[:at] + b"../" + body[at + 3:])
        err, match = ValueError, "leaves the database directory"
    path.write_bytes(bytes(bad))
    with pytest.raises(err, match=match):
        ocdbt.Database(root)


def _ts_zstd_chunk(root, data: np.ndarray, level: int) -> bytes:
    """The one chunk a tensorstore zarr array writes under ``root`` for
    ``data`` with zstd at ``level``."""
    arr = ts.open({"driver": "zarr", "kvstore": f"file://{root}/",
                   "metadata": {"shape": list(data.shape),
                                "chunks": list(data.shape),
                                "dtype": data.dtype.str,
                                "compressor": {"id": "zstd",
                                               "level": level}}},
                  create=True).result()
    arr.write(data).result()
    return (root / ".".join("0" * data.ndim)).read_bytes()


@pytest.mark.parametrize("level", [-3, 1, 3, 9, 19, 22])
def test_zstd_decodes_chunks_tensorstore_compressed(tmp_path, level):
    """Random f32 (Huffman literals), repetitive ints (long matches,
    repeat offsets) and text-like bytes (FSE tables of every mode)."""
    rng = np.random.RandomState(level + 10)
    cases = [rng.randn(200, 300).astype(np.float32),
             np.tile(np.arange(1000, dtype=np.int32), 70).reshape(70, 1000),
             np.frombuffer((" ".join(rng.choice(
                 ["attend", "listen", "spell", "beam", "frame", "token"],
                 20000))).encode(), np.uint8).copy()]
    for i, data in enumerate(cases):
        chunk = _ts_zstd_chunk(tmp_path / str(i), data, level)
        assert chunk[:4] == b"\x28\xb5\x2f\xfd"
        assert zstd.decompress(chunk) == data.tobytes()


def _frame(blocks, content=None, checksum=None, dict_id=None):
    """A zstd frame by hand: ``blocks`` [(type, payload, size)], the
    content size (single segment) and the checksum when given."""
    fhd = 0x20 if content is not None else 0
    head = b""
    if dict_id is not None:
        fhd |= 3
        head += struct.pack("<I", dict_id)
    if checksum is not None:
        fhd |= 4
    if content is not None:
        if content < 256:
            head += bytes([content])
        else:
            fhd |= 0x40
            head += struct.pack("<H", content - 256)
    else:
        head = bytes([0x50]) + head         # window 1 MB
    out = b"\x28\xb5\x2f\xfd" + bytes([fhd]) + head
    for i, (kind, payload, size) in enumerate(blocks):
        last = i == len(blocks) - 1
        out += struct.pack("<I", last | kind << 1 | size << 3)[:3] + payload
    if checksum is not None:
        out += struct.pack("<I", checksum)
    return out


def test_zstd_decodes_hand_made_frames():
    data = bytes(range(200)) * 3
    raw = _frame([(0, data, len(data))], content=len(data))
    assert zstd.decompress(raw) == data
    rle = _frame([(1, b"\x07", 5000), (0, b"tail", 4)], content=5004)
    assert zstd.decompress(rle) == b"\x07" * 5000 + b"tail"
    empty = _frame([(0, b"", 0)], content=0)
    assert zstd.decompress(empty) == b""
    streamed = _frame([(0, b"abc", 3), (1, b"z", 10)])   # no content size
    assert zstd.decompress(streamed) == b"abc" + b"z" * 10
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert zstd.decompress(raw + skip + rle + empty + skip) == (
        data + b"\x07" * 5000 + b"tail")
    checked = _frame([(0, data, len(data))], content=len(data),
                     checksum=zstd.xxh64(data) & 0xFFFFFFFF)
    assert zstd.decompress(checked) == data


def test_xxh64_known_values():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999
    text = b"Nobody inspects the spammish repetition"
    assert zstd.xxh64(text) == 0xFBCEA83C8A378BF1


@pytest.mark.parametrize("fault", ["checksum", "dictionary", "truncated",
                                   "magic", "reserved_block",
                                   "oversized_block"])
def test_zstd_refuses_bad_frames(fault):
    data = b"orbax" * 40
    good = _frame([(0, data, len(data))], content=len(data),
                  checksum=zstd.xxh64(data) & 0xFFFFFFFF)
    if fault == "checksum":
        bad, match = good[:-1] + bytes([good[-1] ^ 0x55]), "checksum mismatch"
    elif fault == "dictionary":
        bad = _frame([(0, data, len(data))], content=len(data),
                     dict_id=0xC0FFEE)
        match = f"dictionary {0xC0FFEE}"
    elif fault == "truncated":
        bad, match = good[:-30], "truncated"
    elif fault == "magic":
        bad, match = b"\x00" + good[1:], "bad frame magic"
    elif fault == "reserved_block":
        bad, match = _frame([(3, b"", 0)]), "reserved block type"
    else:                              # 200,000 > the 128 KB block maximum
        bad, match = _frame([(1, b"x", 200000)]), "above its maximum size"
    with pytest.raises(ValueError, match=match):
        zstd.decompress(bad)


def test_zstd_without_a_compiler_raises_and_writes_nothing(
        tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(zstd, "_lib", None)
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    before = sorted(p.name for p in zstd.SOURCE.parent.iterdir())
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        zstd.decompress(b"\x28\xb5\x2f\xfd")
    assert zstd._lib is None
    assert sorted(p.name for p in zstd.SOURCE.parent.iterdir()) == before
    assert not list((tmp_path / "build").glob("*"))


# --------------------------------------------------------- entry points

@pytest.fixture(scope="module")
def corpus_run(tmp_path_factory):
    """A tiny corpus and config (``test_torch_port_train._train_config``),
    the JAX package's init of its model saved as an orbax directory by the
    JAX package, and the same weights as the port's torch checkpoint."""
    from tests.test_torch_port_train import _train_config
    d = tmp_path_factory.mktemp("orbax_jax_entry")
    cfg_path = _train_config(d)
    cfg = yaml.safe_load(cfg_path.read_text())
    vocab = 3 + len(Path(cfg["data"]["text"]["vocab_file"]
                         ).read_text().split())
    jp = JaxASR(40, vocab, cfg["model"]).init(jax.random.PRNGKey(4))
    jax_save(str(d / "jax.pth"), jp, None, 5, {"wer": 0.9}, fmt="orbax")
    model = asr_from_arrays(40, vocab, cfg["model"], jax_arrays(jp), "cpu")
    torch_ckpt.save_checkpoint(d / "port.pth", model, global_step=5)
    return {"dir": d, "cfg": cfg, "cfg_path": cfg_path, "vocab": vocab,
            "jp": jp}


def _test_config(run, tmp_path, name, **decode):
    c = copy.deepcopy(run["cfg"])
    c["data"]["corpus"]["dev_split"] = ["dev-clean"]
    c["data"]["corpus"]["test_split"] = ["dev-clean"]
    c["decode"] = {"beam_size": 2, "min_len_ratio": 0.05,
                   "max_len_ratio": 0.6, "ctc_weight": 0.3, **decode}
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(c))
    return path


def _csvs(out):
    return {f.name: f.read_text() for f in sorted(out.glob("*.csv"))}


def test_main_test_and_transcribe_take_a_jax_directory(corpus_run,
                                                       tmp_path):
    """``main --test --load jax.pth/`` writes the CSVs that ``--load`` of
    the same weights as the port's torch checkpoint writes, and
    ``transcribe`` the same rows."""
    d = corpus_run["dir"]
    outs, rows = {}, {}
    wavs = sorted(str(p) for p in (Path(corpus_run["cfg"]["data"]["corpus"][
        "path"]) / "dev-clean").rglob("*.wav"))
    for name in ("jax", "port"):
        cfg = _test_config(corpus_run, tmp_path, name)
        port_main.main(["--config", str(cfg), "--test", "--cpu", "--no-msg",
                        "--load", str(d / f"{name}.pth"), "--outdir",
                        str(tmp_path / "out")])
        outs[name] = _csvs(tmp_path / "out" / f"{name}_sd0")
        transcribe.main(["--config", str(cfg), "--load",
                         str(d / f"{name}.pth"), "--cpu", "--output",
                         str(tmp_path / f"{name}.tsv"), *wavs])
        rows[name] = (tmp_path / f"{name}.tsv").read_text()
    assert outs["jax"] == outs["port"] and len(outs["jax"]) == 4
    assert len(outs["jax"]["dev_output.csv"].splitlines()) == 4
    assert rows["jax"] == rows["port"]
    assert len(rows["jax"].strip().splitlines()) == len(wavs) == 3


def test_main_load_resumes_a_jax_directory_at_its_step(corpus_run,
                                                       tmp_path, capsys):
    """``main --load jax.pth/`` (a directory with the JAX package's
    ``optimizer/``: its Adadelta state after 5 steps, OCDBT, zstd): the
    model, the optax state and step 5 are taken (the load line names the
    state); step 6 takes the loss the JAX package's solver takes after its
    own ``--load`` of the directory and reaches its weights, and the
    count is 6."""
    from end_to_end_asr_pytorch_tpu.optim import Optimizer as JaxOptimizer
    from tests.test_torch_port_optax_state import (
        PARAM_TOL, _jax_solver, _jax_steps, _random_like,
        _record_port_steps)
    jp = corpus_run["jp"]
    c = copy.deepcopy(corpus_run["cfg"])
    c["hparas"].update(max_step=6, tf_end=1.0)     # tf 1: no random coins
    jopt = JaxOptimizer(c["hparas"], grad_clip=5.0)
    state, step = jopt.init(jp), jax.jit(jopt.step)
    for s in range(5):
        jp, state = step(_random_like(jp, 20 + s, 0.5), state, jp)
    with_opt = tmp_path / "jax_opt.pth"
    jax_save(str(with_opt), jp, state, 5, fmt="orbax")
    assert (with_opt / "optimizer" / "manifest.ocdbt").is_file()
    cfg = tmp_path / "jax.yaml"
    cfg.write_text(yaml.safe_dump(c))
    mp = pytest.MonkeyPatch()
    seen = _record_port_steps(mp, "asr")
    capsys.readouterr()
    try:
        train.main(["--config", str(cfg), "--cpu", "--logdir",
                    str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt"),
                    "--load", str(with_opt)])
    finally:
        mp.undo()
    said = capsys.readouterr().out
    assert "@ step 5 (optimizer state: adadelta, count 5)" in said
    assert "not read" not in said and "afresh" not in said
    ck = torch.load(str(tmp_path / "ckpt" / "jax_sd0" / "latest.pth"),
                    weights_only=True)
    assert ck["global_step"] == 6 and int(ck["optimizer"]["count"]) == 6
    solver = _jax_solver("asr", c, cfg, corpus_run["vocab"], with_opt,
                         tmp_path)
    assert solver.step == 5
    assert len(seen) == 1
    losses = _jax_steps(solver, "asr", [seen[0][0]])
    np.testing.assert_allclose(seen[0][1], losses[0], rtol=1e-5)
    model = ASR(40, corpus_run["vocab"], c["model"], device="cpu")
    jax_ckpt.load_checkpoint(str(tmp_path / "ckpt" / "jax_sd0" /
                                 "latest.pth"), model)
    got = model.state_dict()
    for path, w in jax_arrays(solver.params).items():
        name = port_name(path)
        np.testing.assert_allclose(got[name].numpy(),
                                   _to_port_layout(name, w), err_msg=name,
                                   **PARAM_TOL)


def test_lm_path_takes_a_jax_lm_directory(corpus_run, tmp_path):
    """``decode.lm_path`` on an RNN-LM orbax directory the JAX package
    wrote fuses the LM as its torch checkpoint of the same weights does."""
    vocab = corpus_run["vocab"]
    lm_cfg = {"module": "LSTM", "dim": 16, "emb_dim": 16, "layer": 2}
    jl = JaxLM(vocab, lm_cfg).init(jax.random.PRNGKey(8))
    jax_save(str(tmp_path / "lm_jax.pth"), jl, None, 3, fmt="orbax")
    lm = lm_from_arrays(vocab, lm_cfg, jax_arrays(jl), "cpu")
    torch_ckpt.save_checkpoint(tmp_path / "lm_port.pth", lm, global_step=3)
    (tmp_path / "lm.yaml").write_text(yaml.safe_dump({**LM_YAML,
                                                      "model": lm_cfg}))
    outs = {}
    for name in ("jax", "port"):
        cfg = _test_config(corpus_run, tmp_path, f"lm_{name}",
                           lm_weight=0.5, lm_config=str(tmp_path / "lm.yaml"),
                           lm_path=str(tmp_path / f"lm_{name}.pth"))
        port_main.main(["--config", str(cfg), "--test", "--cpu", "--no-msg",
                        "--load", str(corpus_run["dir"] / "port.pth"),
                        "--outdir", str(tmp_path / "out")])
        outs[name] = _csvs(tmp_path / "out" / f"lm_{name}_sd0")
    assert outs["jax"] == outs["port"] and len(outs["jax"]) == 4


def _unpack(d):
    import base64
    return np.frombuffer(base64.b64decode(d["b64"]),
                         np.dtype(d["dtype"])).reshape(d["shape"])


def test_the_committed_fixture_is_the_jax_init_and_its_outputs_hold(
        tmp_path):
    """``tests/fixtures/jax_orbax_las`` (``make_jax_orbax_fixture.py``):
    its leaves equal the JAX package's init of ``las.yaml``'s model at seed
    0, and the port on the CPU, through ``main --test``'s Solver with
    ``--load`` on it, gives the recorded JAX outputs (encoder output and
    CTC log-probs within 1e-5, every beam's tokens and score)."""
    from tests.make_jax_orbax_fixture import WAVE_LENS, fixture_waves
    ref = json.loads((FIXTURE / "outputs.json").read_text())
    jp = JaxASR(40, V, LAS["model"]).init(jax.random.PRNGKey(ref["seed"]))
    ck = orbax.read_orbax(FIXTURE / "best_att.pth")
    _assert_same(ck["model"], _by_port_name(jp), "fixture")
    pcm = _unpack(ref["pcm16"])
    np.testing.assert_array_equal(pcm, fixture_waves(ref["seed"]))
    assert ref["wave_len"] == list(WAVE_LENS)

    cfg = copy.deepcopy(LAS)
    cfg["decode"] = ref["decode"]
    (tmp_path / "las.yaml").write_text(yaml.safe_dump(cfg))
    paras = port_main.build_parser().parse_args(
        ["--config", str(tmp_path / "las.yaml"), "--test", "--cpu",
         "--load", str(FIXTURE / "best_att.pth"), "--outdir",
         str(tmp_path / "out"), "--no-msg"])
    solver = test_asr.Solver(cfg, paras)
    solver.feat_dim, solver.vocab_size = ref["feat_dim"], ref["vocab_size"]
    solver.set_model()
    wave = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    wave_len = torch.tensor(ref["wave_len"], dtype=torch.int32)
    with torch.no_grad():
        feat, feat_len = solver.frontend(wave, wave_len)
        enc, enc_len = solver.model.encode(feat, feat_len)
        lp = solver.model.ctc_output(enc)
        out = solver.decoder.forward(feat, feat_len)
    assert enc_len.tolist() == ref["enc_len"]
    for b, u in enumerate(ref["utts"]):
        n = ref["enc_len"][b]
        np.testing.assert_allclose(enc[b, :n].numpy(), _unpack(u["enc"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(lp[b, :n].numpy(),
                                   _unpack(u["ctc_log_probs"]), rtol=0,
                                   atol=1e-5)
        for k, (toks, score) in enumerate(zip(u["beam_tokens"],
                                              u["beam_scores"])):
            L = int(out.lengths[b, k])
            assert out.tokens[b, k, :L].tolist() == toks
            assert abs(float(out.scores[b, k]) - score) <= 1e-5
