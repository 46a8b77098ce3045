"""The port's synthetic data against the JAX package's: the same seeds give
byte-identical priors and batches (both are numpy)."""
import numpy as np
import pytest

from repro.data import synthetic as jsyn

from repro_torch.data import synthetic as tsyn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("alpha,seed", [(0.5, 0), (0.1, 7)])
def test_dirichlet_priors_are_identical(alpha, seed):
    for got, want in zip(tsyn.dirichlet_partition(4, 301, alpha, seed),
                         jsyn.dirichlet_partition(4, 301, alpha, seed)):
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_client_streams_give_identical_batches(seed):
    got = tsyn.make_client_streams(3, 257, seq_len=16, batch_size=2,
                                   alpha=0.5, seed=seed)
    want = jsyn.make_client_streams(3, 257, seq_len=16, batch_size=2,
                                    alpha=0.5, seed=seed)
    for g, w in zip(got, want):
        assert g.client_prior.tobytes() == w.client_prior.tobytes()
        for _ in range(3):
            bg, bw = g.next_batch(), w.next_batch()
            assert sorted(bg) == sorted(bw) == ["labels", "tokens"]
            for k in bw:
                assert bg[k].dtype == bw[k].dtype == np.int32
                assert bg[k].tobytes() == bw[k].tobytes()


def test_full_vocab_stream_is_identical():
    """The chip round's stream: Qwen1.5-0.5B's vocab, one short batch."""
    got = tsyn.make_client_streams(1, 151936, seq_len=8, batch_size=2,
                                   seed=5)[0].next_batch()
    want = jsyn.make_client_streams(1, 151936, seq_len=8, batch_size=2,
                                    seed=5)[0].next_batch()
    for k in want:
        assert got[k].tobytes() == want[k].tobytes()
