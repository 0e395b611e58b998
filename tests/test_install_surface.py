"""What the retrieval path needs installed, and where JAX caches its
compiled programs."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "pydantic", "pandas", "sklearn", "nltk", "transformers")


def _run(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_retrieval_path_runs_without_heavy_packages():
    """The retrieval, sharding and serving modules import, and a served
    search runs, with flax, pydantic, pandas, sklearn, nltk and
    transformers unimportable."""
    out = _run(f"""
        import sys
        for m in {BLOCKED!r}:
            sys.modules[m] = None
        import a_nice_rag_tpu.retrieval, a_nice_rag_tpu.parallel
        import a_nice_rag_tpu.index, a_nice_rag_tpu.ops
        from a_nice_rag_tpu.serving.serve_cli import build_state
        from a_nice_rag_tpu.index import build_index
        from a_nice_rag_tpu.testing import synth_corpus

        c = synth_corpus(n_docs=256, dim=16, n_queries=2, seed=1)
        idx = build_index(ids=c.ids, sources=c.sources,
                          contents=c.contents, embeddings=c.embeddings,
                          token_lists=c.tokens)
        state = build_state(idx, ("voyage-3-large",), use_bm25=True)
        ids, _, _ = state.retriever(
            {{"voyage-3-large": c.query_embeddings["voyage-3-large"]}},
            idx.pad_term_ids(c.query_tokens, 8),
            {{"voyage-3-large": 5.0, "BM25": 1.0}})
        assert ids.shape[0] == 2 and (ids[:, 0] >= 0).all()
        for m in {BLOCKED!r}:
            assert sys.modules[m] is None, m
        print("ok")
    """)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and nothing else is set; without it the cache is <repo>/.cache/jax."""
    extra = {}
    if env_dir:
        extra["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = _run("""
        import jax
        from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache
        used = enable_compile_cache()
        print(used)
        print(jax.config.jax_compilation_cache_dir)
    """, extra)
    assert out.returncode == 0, out.stderr[-2000:]
    used, configured = out.stdout.split()[-2:]
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(REPO, ".cache", "jax"))
    assert used == configured == want
