"""MovieLens-1M readers (reference: python/paddle/dataset/movielens.py).

Samples (reference order): (user_id, gender_id, age_id, job_id,
movie_id, category_ids seq, title_ids seq, rating float).  Synthetic:
ratings follow a low-rank user x movie preference structure (learnable
by the recommender book model).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "train", "test", "max_user_id", "max_movie_id", "max_job_id",
    "age_table", "movie_categories",
]

_MAX_USER = 6040
_MAX_MOVIE = 3952
_N_CAT = 18
_TITLE_VOCAB = 5175


def max_user_id():
    return _MAX_USER


def max_movie_id():
    return _MAX_MOVIE


def max_job_id():
    return 20


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def movie_categories():
    return {i: "cat%d" % i for i in range(_N_CAT)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        u_factor = np.random.RandomState(99).randn(_MAX_USER + 1, 4)
        m_factor = np.random.RandomState(98).randn(_MAX_MOVIE + 1, 4)
        for _ in range(n):
            u = int(rng.randint(1, _MAX_USER + 1))
            m = int(rng.randint(1, _MAX_MOVIE + 1))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, 7))
            job = int(rng.randint(0, 21))
            cats = rng.randint(0, _N_CAT, rng.randint(1, 4)).astype("int64")
            title = rng.randint(0, _TITLE_VOCAB, rng.randint(2, 8)).astype("int64")
            score = float(np.clip(3.0 + u_factor[u] @ m_factor[m], 1.0, 5.0))
            yield u, gender, age, job, m, cats, title, score

    return reader


def train(size: int = 2048):
    return _reader(size, 0)


def test(size: int = 256):
    return _reader(size, 1)
