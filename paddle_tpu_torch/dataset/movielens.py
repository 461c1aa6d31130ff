"""MovieLens-1M ratings (reference: python/paddle/dataset/movielens.py —
sample = [user_id, gender, age, job, movie_id, category_ids, title_ids,
rating]). Parses the real `ml-1m.zip` from the cache dir when present
(reference movielens.py:30-190: `::`-separated ratings/users/movies
tables, gender M/F index, age bucket index, genre + title-word dicts);
otherwise synthesizes users/movies with latent-factor ratings so
recommender_system converges."""
import os
import re
import zipfile

import numpy as np

from .common import cache_path, rng_for

_N_USERS, _N_MOVIES = 944, 1683
_N_CATEGORIES, _TITLE_VOCAB = 19, 1512
_N_AGES, _N_JOBS = 7, 21
_DIM = 8

_AGE_TABLE = [1, 18, 25, 35, 45, 50, 56]


def _real_archive():
    path = cache_path("movielens", "ml-1m.zip")
    return path if os.path.exists(path) else None


_TABLES_CACHE = {}


def _real_tables():
    """(users, movies, ratings, cat_dict, title_dict) from ml-1m.zip.
    Memoized per archive: the metadata accessors and every reader epoch
    would otherwise re-parse ~1M rating lines each."""
    path = _real_archive()
    key = (path, os.path.getmtime(path))
    if key in _TABLES_CACHE:
        return _TABLES_CACHE[key]
    with zipfile.ZipFile(_real_archive()) as zf:
        def lines(suffix):
            name = next(n for n in zf.namelist() if n.endswith(suffix))
            return zf.read(name).decode("latin1").splitlines()

        users = {}
        for ln in lines("users.dat"):
            uid, gender, age, job, _zip = ln.strip().split("::")
            users[int(uid)] = (0 if gender == "M" else 1,
                               _AGE_TABLE.index(int(age)), int(job))
        cat_dict, title_dict = {}, {}
        movies = {}
        for ln in lines("movies.dat"):
            mid, title, genres = ln.strip().split("::")
            cats = []
            for g in genres.split("|"):
                cats.append(cat_dict.setdefault(g, len(cat_dict)))
            words = re.sub(r"\(\d{4}\)", "", title).lower().split()
            tids = [title_dict.setdefault(w, len(title_dict))
                    for w in words]
            movies[int(mid)] = (cats, tids)
        ratings = []
        for ln in lines("ratings.dat"):
            uid, mid, rating, _ts = ln.strip().split("::")
            ratings.append((int(uid), int(mid), float(rating)))
    _TABLES_CACHE[key] = (users, movies, ratings, cat_dict, title_dict)
    return _TABLES_CACHE[key]


def max_user_id():
    if _real_archive():
        return max(_real_tables()[0])
    return _N_USERS - 1


def max_movie_id():
    if _real_archive():
        return max(_real_tables()[1])
    return _N_MOVIES - 1


def max_job_id():
    return _N_JOBS - 1


def age_table():
    return list(_AGE_TABLE)


def movie_categories():
    if _real_archive():
        return dict(_real_tables()[3])
    return {("cat%d" % i): i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    if _real_archive():
        return dict(_real_tables()[4])
    return {("t%d" % i): i for i in range(_TITLE_VOCAB)}


def _real_reader(split):
    def reader():
        users, movies, ratings, _c, _t = _real_tables()
        # reference uses a hash-based train/test split; a deterministic
        # 1-in-10 index split keeps the same 90/10 proportions
        for i, (uid, mid, rating) in enumerate(ratings):
            in_test = (i % 10) == 9
            if in_test != (split == "test"):
                continue
            gender, age, job = users[uid]
            cats, tids = movies[mid]
            yield [uid, gender, age, job, mid, cats, tids, rating]
    return reader


def _latents():
    rng = rng_for("movielens", "latent")
    u = rng.randn(_N_USERS, _DIM).astype(np.float32)
    m = rng.randn(_N_MOVIES, _DIM).astype(np.float32)
    return u, m


def _make(split, n):
    def reader():
        u_lat, m_lat = _latents()
        rng = rng_for("movielens", split)
        meta = rng_for("movielens", "meta")
        genders = meta.randint(0, 2, _N_USERS)
        ages = meta.randint(0, _N_AGES, _N_USERS)
        jobs = meta.randint(0, _N_JOBS, _N_USERS)
        cats = [list(map(int, meta.randint(0, _N_CATEGORIES,
                                           meta.randint(1, 4))))
                for _ in range(_N_MOVIES)]
        titles = [list(map(int, meta.randint(0, _TITLE_VOCAB,
                                             meta.randint(2, 6))))
                  for _ in range(_N_MOVIES)]
        for _ in range(n):
            u = int(rng.randint(_N_USERS))
            m = int(rng.randint(_N_MOVIES))
            score = float(u_lat[u] @ m_lat[m])
            rating = float(np.clip(np.round(3.0 + score), 1, 5))
            yield [u, int(genders[u]), int(ages[u]), int(jobs[u]),
                   m, cats[m], titles[m], rating]
    return reader


def train():
    if _real_archive():
        return _real_reader("train")
    return _make("train", 8192)


def test():
    if _real_archive():
        return _real_reader("test")
    return _make("test", 1024)
