"""MovieLens-1M (``paddle_tpu/dataset/movielens.py``).  A sample is
``(user_id, gender_id, age_id, job_id, movie_id, category_ids,
title_ids, score)``; the constants are the vocabulary sizes
``models.recommender`` builds its embeddings from.  Synthetic: ids
uniform in range, 1-3 categories, titles of 2-9 words, a score from the
user and movie ids plus noise."""

import numpy as np

MAX_USER = 6040
MAX_MOVIE = 3952
NUM_GENDER = 2
NUM_AGE = 7
NUM_JOB = 21
NUM_CATEGORY = 18
TITLE_VOCAB = 5175


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return NUM_JOB - 1


def _synthetic(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            user = int(rng.randint(1, MAX_USER + 1))
            gender = int(rng.randint(0, NUM_GENDER))
            age = int(rng.randint(0, NUM_AGE))
            job = int(rng.randint(0, NUM_JOB))
            movie = int(rng.randint(1, MAX_MOVIE + 1))
            ncat = int(rng.randint(1, 4))
            cats = rng.randint(0, NUM_CATEGORY, ncat).astype(np.int64).tolist()
            ntit = int(rng.randint(2, 10))
            title = rng.randint(0, TITLE_VOCAB, ntit).astype(np.int64).tolist()
            score = float((user % 5) * 0.5 + (movie % 5) * 0.5
                          + rng.randn() * 0.3 + 1.0)
            yield user, gender, age, job, movie, cats, title, score

    return reader


def train():
    return _synthetic(4096, 21)


def test():
    return _synthetic(512, 22)
