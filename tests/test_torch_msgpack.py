"""The port's msgpack reader against ``flax.serialization``.

Trees written by `flax.serialization.to_bytes` / `msgpack_serialize` read
back leaf for leaf with equal bits: a TrainState with the JAX engine's optax
chain (clip → inject_hyperparams(adamw) with its masked decay) and an EMA; a
bfloat16 leaf (uint16 bits → torch.bfloat16); a chunked array (flax splits
arrays above its chunk size, shrunk here); and the scalar kinds msgpack and
flax's extension types carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from nabladft_tpu.train.state import TrainState
from nabladft_tpu_torch.train.checkpoints import load_flax_state, load_state
from nabladft_tpu_torch.utils import msgpack


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: torch's intra-op threads would only contend with the
    other test workers' (pytest-xdist). Restored after this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want, path="") -> None:
    """Leaf for leaf, equal bits (flax's own restore as the reference)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _train_state():
    rng = np.random.default_rng(0)
    params = {"params": {"Dense_0": {"kernel": jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
                                     "bias": jnp.asarray(rng.normal(size=3), jnp.float32)},
                         "gamma": jnp.asarray(0.5, jnp.float32)}}
    adamw = optax.inject_hyperparams(lambda learning_rate: optax.adamw(
        learning_rate, weight_decay=0.1,
        mask=lambda p: jax.tree_util.tree_map(lambda x: x.ndim > 1, p)))(learning_rate=1e-3)
    tx = optax.chain(optax.clip_by_global_norm(1.0), adamw)
    state = TrainState.create(params, tx, ema=True)
    grads = jax.tree_util.tree_map(lambda x: jnp.ones_like(x) * 0.3, params)
    upd, opt_state = tx.update(grads, state.opt_state, state.params)
    return state.replace(step=state.step + 1, params=optax.apply_updates(params, upd),
                         opt_state=opt_state)


def test_train_state_reads_back_bit_for_bit(tmp_path):
    state = _train_state()
    blob = serialization.to_bytes(state)
    _same(msgpack.unpackb(blob), serialization.msgpack_restore(blob))
    (tmp_path / "last.ckpt").write_bytes(blob)
    got = load_state(tmp_path / "last.ckpt")
    assert set(got) == {"step", "params", "opt_state", "ema_params"}
    inject = got["opt_state"]["1"]
    assert int(inject["count"]) == 1
    assert float(inject["hyperparams"]["learning_rate"]) == pytest.approx(1e-3)
    assert np.array_equal(inject["inner_state"]["0"]["mu"]["params"]["Dense_0"]["kernel"],
                          np.asarray(state.opt_state[1].inner_state[0].mu["params"]["Dense_0"]
                                     ["kernel"]))


def test_bfloat16_leaf_and_scalars():
    tree = {"w": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4), jnp.bfloat16),
            "s": np.float32(1.25), "bs": jnp.bfloat16(2.5).reshape(()),
            "i": 7, "neg": -33, "big": 2 ** 40, "f": 0.1, "t": True, "n": None, "txt": "ok",
            "c": 1.5 - 2j, "empty": np.zeros((0, 3), np.int64)}
    blob = serialization.msgpack_serialize(tree)
    got = msgpack.unpackb(blob)
    _same(got, serialization.msgpack_restore(blob))
    assert got["w"].dtype == torch.bfloat16 and got["w"].float()[2, 3] == 3.0


def test_chunked_array(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(50, dtype=np.float32).reshape(5, 10)
    blob = serialization.msgpack_serialize({"a": {"big": arr}, "small": np.ones(3)})
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack.unpackb(blob)
    _same(got, serialization.msgpack_restore(blob))
    assert got["a"]["big"].shape == (5, 10)


def test_other_files_are_refused(tmp_path):
    (tmp_path / "junk.ckpt").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="neither a checkpoint"):
        load_state(tmp_path / "junk.ckpt")
    (tmp_path / "arr.msgpack").write_bytes(serialization.msgpack_serialize({"x": np.ones(2)}))
    with pytest.raises(ValueError, match="no flax TrainState"):
        load_flax_state(tmp_path / "arr.msgpack")
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(serialization.to_bytes(_train_state())[:-5])
