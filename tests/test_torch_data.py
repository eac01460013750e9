"""The port's data pipeline (``repro_torch.data``) against the JAX package's
on the CPU: the n-gram bank and every batch byte-equal, shards and their
union, and the iterator advancing ``DataState`` (the resume point a
checkpoint carries)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro_torch import data as tdata  # noqa: E402


@pytest.mark.parametrize("vocab,seq,seed", [(256, 33, 0), (8192, 257, 3), (102400, 65, 7)])
def test_bank_and_batches_byte_equal(vocab, seq, seed):
    j = jdata.SyntheticLM(vocab, seq, seed=seed)
    t = tdata.SyntheticLM(vocab, seq, seed=seed)
    assert t.bank.dtype == np.int32 and t.bank.tobytes() == j.bank.tobytes()
    for step in (0, 1, 17):
        got, want = t.batch(step, 8), j.batch(step, 8)
        assert got.dtype == want.dtype == np.int32 and got.shape == (8, seq)
        assert got.tobytes() == want.tobytes()
        assert int(got.min()) >= 0 and int(got.max()) < vocab


def test_shards():
    j = jdata.SyntheticLM(512, 64, seed=1)
    t = tdata.SyntheticLM(512, 64, seed=1)
    parts = []
    for shard in range(4):
        got = t.batch(5, 16, shard, 4)
        assert got.shape == (4, 64)
        assert got.tobytes() == j.batch(5, 16, shard, 4).tobytes()
        parts.append(got)
    # shards draw from their own generators: no two alike
    assert len({p.tobytes() for p in parts}) == 4


def test_iterator_advances_state_and_resumes():
    js, ts = jdata.DataState(seed=2), tdata.DataState(seed=2)
    jit = jdata.make_batch_iterator(300, 16, 4, state=js)
    tit = tdata.make_batch_iterator(300, 16, 4, state=ts, device="cpu")
    for expect in range(3):
        (jstep, jb), (tstep, tb) = next(jit), next(tit)
        assert tstep == jstep == expect and ts.next_step == js.next_step == expect + 1
        for k in ("tokens", "targets"):
            got = tb[k]
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            assert got.shape == (4, 16)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jb[k]))
        # targets are the tokens shifted by one, two views of one copy
        np.testing.assert_array_equal(tb["targets"][:, :-1].numpy(), tb["tokens"][:, 1:].numpy())
        assert tb["tokens"].untyped_storage().data_ptr() == tb["targets"].untyped_storage().data_ptr()
    # a fresh iterator from the saved resume point continues the stream
    resumed = tdata.make_batch_iterator(300, 16, 4, state=tdata.DataState(2, ts.next_step),
                                        device="cpu")
    (jstep, jb), (rstep, rb) = next(jit), next(resumed)
    assert rstep == jstep == 3
    np.testing.assert_array_equal(rb["tokens"].numpy(), np.asarray(jb["tokens"]))


def test_iterator_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.make_batch_iterator(300, 16, 4, state=tdata.DataState(0))
