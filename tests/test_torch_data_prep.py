"""The port's data preparation against the JAX package's, on the CPU.

``data/ikea.py``, the train half of ``data/preprocessing.py``,
``data/storage.py``, ``data/native.py`` (the JSON-lines parser, built with
the host compiler into the port's ``_build/``), ``utils/invocation.py`` and
the JSON-lines path of ``data/replay_buffer.py`` take the same inputs on
both sides (hand-made sessions after ``tests/test_ikea.py``,
``tests/test_native.py`` and ``tests/test_preprocessing.py``, and larger
ones drawn from numpy seeds) and must give equal frames, arrays, files and
errors. Nothing here is a float computed two ways, so every comparison is
exact. Where the native library cannot be built, its cases skip with the
reason.
"""

import gzip
import json
from argparse import Namespace

import numpy as np
import pandas as pd
import pytest

from ikea_recommender_tpu.data import ikea as ref_ikea
from ikea_recommender_tpu.data import native as ref_native
from ikea_recommender_tpu.data import preprocessing as ref_pre
from ikea_recommender_tpu.data import replay_buffer as ref_rb
from ikea_recommender_tpu.data import storage as ref_storage
from ikea_recommender_tpu.data.tokenizer import Tokenizer as RefTokenizer
from ikea_recommender_tpu.utils import invocation as ref_invocation
from ikea_recommender_tpu_torch.data import ikea, native, preprocessing, replay_buffer, storage
from ikea_recommender_tpu_torch.data.tokenizer import Tokenizer
from ikea_recommender_tpu_torch.utils import invocation

REWARDS = {"click_inspiration": 1.0, "select_content": 1.0, "add_to_cart": 5.0}
EVENTS = [  # (session, item, action type), as tests/test_ikea.py
    ("A", "p1", "view_item"),
    ("A", "i1", "click_inspiration"),
    ("A", "p2", "view_item"),
    ("A", "p2", "add_to_cart"),
    ("A", "i2", "click_inspiration"),
    ("A", "p3", "view_item"),
    ("B", "i1", "select_content"),
    ("B", "p1", "view_item"),
]
ACTIONS = ("view_item", "click_inspiration", "select_content", "add_to_cart", "remove")


def assert_frames_equal(got, want):
    """Same columns in the same order, same values and dtypes; columns of
    arrays compared as stacked arrays."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if len(w) and isinstance(w[0], np.ndarray):
            g, w = np.stack(g), np.stack(w)
        np.testing.assert_array_equal(g, w, err_msg=c)
        assert g.dtype == w.dtype, c


def _ikea_frame(events=EVENTS):
    df = pd.DataFrame(events, columns=["sessionID", "item_id", "action_type"])
    df["market"] = "de"
    return df


def _random_events(seed, n_sessions=40):
    rs = np.random.RandomState(seed)
    events = []
    for s in range(n_sessions):
        for _ in range(rs.randint(1, 12)):
            kind = ACTIONS[rs.randint(len(ACTIONS))]
            click = "inspiration" in kind or "content" in kind
            item = f"i{rs.randint(6)}" if click else f"p{rs.randint(9)}"
            events.append((f"s{s}", item, kind))
    return events


def _tokenizers(cls, events):
    items = sorted({e[1] for e in events})
    return (
        cls(items, unknown=True),
        cls(sorted(i for i in items if i.startswith("i")), unknown=True),
        cls(["de", "se"]),
    )


def _records(seed, n=12):
    """Raw session records (the GA export's schema) from a numpy seed,
    some sessions sharing their metadata triple, some events ragged."""
    rs = np.random.RandomState(seed)
    out = []
    for s in range(n):
        events = []
        for e in range(rs.randint(1, 6)):
            ev = {"item_id": f"p{rs.randint(5)}", "action": ACTIONS[rs.randint(4)],
                  "timestamp_ms": int(1000 * s + e), "propensity": 0.5}
            if rs.rand() < 0.2:
                ev["feed_location"] = "top"
            if rs.rand() < 0.1:
                ev["extra"] = "ragged"  # a column most rows lack: those rows drop
            events.append(ev)
        out.append({"market": ["de", "se"][s % 2], "fullVisitorId": f"v{s // 2}",
                    "start_time_ms": 100 * (s // 3), "visitNumber": s, "events": events})
    return out


# ---- data/ikea.py ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_prepare_sessions_and_buffer_columns(seed):
    recs = _records(seed)
    got = ikea.prepare_sessions(recs, session_prefix="3_")
    want = ref_ikea.prepare_sessions(recs, session_prefix="3_")
    pd.testing.assert_frame_equal(got, want)
    got = ikea.prepare_for_replay_buffer(ikea.add_reward_simple(got, REWARDS))
    want = ref_ikea.prepare_for_replay_buffer(ref_ikea.add_reward_simple(want, REWARDS))
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("events", [EVENTS, EVENTS[:2] + [("X", "p1", "view_item")],
                                    _random_events(3)], ids=["spec", "no_click", "random"])
def test_mark_last_inspiration_click(events):
    np.testing.assert_array_equal(
        ikea.mark_last_inspiration_click(_ikea_frame(events)),
        ref_ikea.mark_last_inspiration_click(_ikea_frame(events)),
    )


@pytest.mark.parametrize("future_steps", [1, "all", 2, 3])
@pytest.mark.parametrize("pad_pos", ["end", "beg"])
@pytest.mark.parametrize("events", [EVENTS, _random_events(5)], ids=["spec", "random"])
def test_ikea_preprocess_train_data(events, pad_pos, future_steps):
    sides = []
    for mod, cls in ((ikea, Tokenizer), (ref_ikea, RefTokenizer)):
        inp, out, market = _tokenizers(cls, events)
        df = mod.add_reward_simple(_ikea_frame(events), REWARDS)
        buf = mod.preprocess_train_data(
            df, padding_id=inp.pad_idx, state_len=4, tokenizer_market=market,
            tokenizer_input=inp, tokenizer_output=out, pad_pos=pad_pos,
            future_steps_next_state=future_steps,
        )
        sides.append((buf, mod.to_eval_frame(buf)))
    assert_frames_equal(sides[0][0], sides[1][0])
    assert_frames_equal(sides[0][1], sides[1][1])


def test_ikea_preprocess_spec_values():
    """The spec case's hand-computed buffer (tests/test_ikea.py), from the port."""
    inp, out, market = _tokenizers(Tokenizer, EVENTS)
    buf = ikea.preprocess_train_data(
        ikea.add_reward_simple(_ikea_frame(), REWARDS), padding_id=inp.pad_idx, state_len=3,
        tokenizer_market=market, tokenizer_input=inp, tokenizer_output=out,
    )
    np.testing.assert_array_equal(buf["action"].to_numpy(), [0, 1, 0])
    np.testing.assert_array_equal(buf["is_end"].to_numpy(), [False, True, True])
    np.testing.assert_array_equal(buf["true_state_len"].to_numpy(), [1, 3, 1])
    np.testing.assert_array_equal(buf["true_next_state_len"].to_numpy(), [2, 3, 1])


def test_prepare_full_data(tmp_path):
    """Two gzip-JSON clickstream files under a prefix, through Storage."""
    for i in range(2):
        text = "\n".join(json.dumps(r) for r in _records(10 + i)) + "\n"
        (tmp_path / f"part-{i}.json.gz").write_bytes(gzip.compress(text.encode()))
    prefix = str(tmp_path / "part-")
    got = ikea.prepare_full_data(prefix, REWARDS, storage=storage.Storage())
    want = ref_ikea.prepare_full_data(prefix, REWARDS, storage=ref_storage.Storage())
    pd.testing.assert_frame_equal(got, want)
    one = ikea.prepare_full_data(prefix, REWARDS, max_files=1)
    pd.testing.assert_frame_equal(one, ref_ikea.prepare_full_data(prefix, REWARDS, max_files=1))


# ---- data/preprocessing.py, the train half ----------------------------------

SESSIONS = {  # as tests/test_preprocessing.py
    "s1": ([1, 2, 3, 4], [0, 0, 0, 1]),
    "s2": ([6, 7, 8, 9, 10, 11], [0, 0, 1, 0, 0, 0]),
    "s3": ([100, 101], [1, 1]),
}


def _session_frame(seed):
    if seed is None:
        rows = [(sid, it, ty) for sid, (items, types) in SESSIONS.items()
                for it, ty in zip(items, types)]
    else:  # interleaved sessions of 1-15 events
        rs = np.random.RandomState(seed)
        sids = np.repeat(np.arange(30), rs.randint(1, 16, 30))
        rs.shuffle(sids)
        rows = [(f"s{s}", int(rs.randint(500)), int(rs.randint(3))) for s in sids]
    df = pd.DataFrame(rows, columns=["SessionID", "Item", "ActionType"])
    df["reward"] = np.where(df["ActionType"] == 1, 5.0, 1.0)
    return df


@pytest.mark.parametrize("seed", [None, 0])
@pytest.mark.parametrize("pad_pos", ["end", "beg"])
def test_preprocess_train_data(seed, pad_pos):
    kw = dict(padding_id=999, state_len=3, pad_pos=pad_pos, session_id_name="SessionID",
              action_name="Item")
    assert_frames_equal(preprocessing.preprocess_train_data(_session_frame(seed), **kw),
                        ref_pre.preprocess_train_data(_session_frame(seed), **kw))


@pytest.mark.parametrize("incl_reward", [False, True])
@pytest.mark.parametrize("seed", [None, 1])
@pytest.mark.parametrize("pad_pos", ["end", "beg"])
def test_preprocess_incl_act_rew(seed, pad_pos, incl_reward):
    kw = dict(padding_id=999, state_len=3, pad_pos=pad_pos, action_to_reward_dict={0: 1.0, 1: 5.0},
              action_type_name="ActionType", session_id_name="SessionID", action_name="Item")
    kw_train = dict(kw, incl_reward=incl_reward)
    assert_frames_equal(
        preprocessing.preprocess_train_data_incl_act_rew(_session_frame(seed), **kw_train),
        ref_pre.preprocess_train_data_incl_act_rew(_session_frame(seed), **kw_train),
    )
    assert_frames_equal(preprocessing.preprocess_val_data_incl_act_rew(_session_frame(seed), **kw),
                        ref_pre.preprocess_val_data_incl_act_rew(_session_frame(seed), **kw))


@pytest.mark.parametrize("mapping,default", [({0: 1.0, 1: 5.0}, 0.0), ({2: -1.5}, 0.25), ({}, 0.0)])
def test_map_rewards(mapping, default):
    types = np.random.RandomState(2).randint(0, 4, 100)
    got = preprocessing.map_rewards(types, mapping, default)
    want = ref_pre.map_rewards(types, mapping, default)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_preprocess_train_data_from_files(tmp_path):
    """Paths go through _read_frame: csv and JSON lines."""
    df = _session_frame(4)
    kw = dict(padding_id=999, state_len=5, session_id_name="SessionID", action_name="Item")
    for name, write in (("s.csv", lambda p: df.to_csv(p, index=False)),
                        ("s.jsonl", lambda p: df.to_json(p, orient="records", lines=True))):
        write(tmp_path / name)
        path = str(tmp_path / name)
        assert_frames_equal(preprocessing.preprocess_train_data(path, **kw),
                            ref_pre.preprocess_train_data(path, **kw))


# ---- data/storage.py ---------------------------------------------------------


def test_storage_local_paths(tmp_path):
    ours, ref = storage.Storage(), ref_storage.Storage()
    with ours.open(str(tmp_path / "deep" / "a.txt"), "w") as fh:  # makes the directory
        fh.write("x")
    ours.copy(str(tmp_path / "deep" / "a.txt"), str(tmp_path / "other" / "b.txt"))
    ours.makedirs(str(tmp_path / "empty"))
    for p in ("deep/a.txt", "other/b.txt", "missing"):
        assert ours.exists(str(tmp_path / p)) == ref.exists(str(tmp_path / p))
    for prefix in ("", "deep", "oth", "zz"):
        prefix = str(tmp_path / prefix)
        assert ours.list_files(prefix) == ref.list_files(prefix)
    assert (tmp_path / "other" / "b.txt").read_text() == "x"


@pytest.mark.parametrize("gz", [False, True])
def test_load_json_gz_records(tmp_path, gz):
    text = "\n".join(json.dumps(r) for r in _records(7)) + "\n\n  \n"
    path = tmp_path / ("r.json.gz" if gz else "r.json")
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    assert storage.load_json_gz_records(str(path)) == ref_storage.load_json_gz_records(str(path))


# ---- utils/invocation.py -----------------------------------------------------


def test_record_invocation(tmp_path):
    args = Namespace(cmd="synth", out=str(tmp_path), n=3, fn=print, scale=0.5)
    invocation.record_invocation(args, str(tmp_path / "ours"))
    ref_invocation.record_invocation(args, str(tmp_path / "ref"))
    got = (tmp_path / "ours" / "command_synth.json").read_text()
    assert got == (tmp_path / "ref" / "command_synth.json").read_text()
    assert "fn" not in json.loads(got)


# ---- data/native.py ----------------------------------------------------------


@pytest.fixture(scope="session")
def ref_native_private_path(tmp_path_factory):
    """Where this process builds its own copy of the reference's library."""
    return str(tmp_path_factory.mktemp("ref_native") / "libikea_native.so")


@pytest.fixture
def native_lib(monkeypatch, ref_native_private_path):
    """Both packages' native parsers, built on first use; skips where the
    host compiler cannot build them.

    The reference builds its library straight into the shared
    ``native/build/libikea_native.so``, so a process that loads it while
    another still writes it fails, and the reference then refuses to load
    for the rest of that process. Here the reference module is pointed at
    a build of its own in this process's temporary directory (its own
    command and flags), with its load state cleared for the test and put
    back afterwards; the shared path is never read."""
    if not native.available():
        pytest.skip("the native JSON-lines parser could not be built (no host C++ compiler?)")
    monkeypatch.setattr(ref_native, "_LIB", ref_native_private_path)
    monkeypatch.setattr(ref_native, "_lib", None)
    monkeypatch.setattr(ref_native, "_build_failed", False)
    if not ref_native.available():
        pytest.skip("the reference's native parser could not be built")
    return native


def _buffer_df(n=500, state_len=10, seed=0):
    rs = np.random.RandomState(seed)
    return pd.DataFrame({
        "state": [rs.randint(0, 100, state_len).tolist() for _ in range(n)],
        "action": rs.randint(0, 100, n),
        "r_act": rs.rand(n).astype(np.float64).round(4),
        "next_state": [rs.randint(0, 100, state_len).tolist() for _ in range(n)],
        "true_state_len": rs.randint(1, state_len + 1, n),
        "true_next_state_len": rs.randint(1, state_len + 1, n),
        "is_end": rs.rand(n) < 0.3,
    })


def _assert_columns_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        assert got[c].dtype == want[c].dtype, c


ROWS = {  # raw JSON lines both parsers read, as tests/test_native.py
    "buffer": _buffer_df().to_json(orient="records", lines=True).encode(),
    "eval_subset_unknown_keys": _buffer_df(50)[["state", "action", "true_state_len"]]
    .assign(extra="ignore me {}[],:").to_json(orient="records", lines=True).encode(),
    "leading_blank_lines": b'\n  \n{"state":[1,2],"action":3}\n',
    "bools_whitespace": (
        '{ "state" : [ 1 , 2 ] , "action" : 7 , "r_act" : 1.5 , "next_state":[3,4], '
        '"true_state_len": 2, "true_next_state_len": 2, "is_end" : 1 }\n'
        '{"is_end":false,"state":[5,6],"action":8,"r_act":-2e-1,"next_state":[7,8],'
        '"true_state_len":1,"true_next_state_len":2}'
    ).encode(),
    "unknown_column_requested": b'{"state":[1,2],"action":3,"action_type":1}\n',
    "empty": b"",
    "blank_only": b"\n \n",
}
BAD_ROWS = {  # the parsers must refuse these, with the same message
    "malformed_row": b'{"state":[1,2],"action":3}\n{"state":[1,2,"x"],"action":4}\n',
    "missing_key": b'{"state":[1,2],"action":3,"r_act":0.5}\n{"state":[4,5],"action":6}\n',
    "ragged_array": b'{"state":[1,2,3],"action":1}\n{"state":[4,5],"action":2}\n',
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_native_parse_matches_reference(native_lib, case):
    before = native_lib.NATIVE_PARSES
    got = native_lib.parse_jsonl_buffer(ROWS[case], ref_rb._TRAIN_COLS)
    want = ref_native.parse_jsonl_buffer(ROWS[case], ref_rb._TRAIN_COLS)
    _assert_columns_equal(got, want)
    assert native_lib.NATIVE_PARSES == before + (got is not None)
    if case == "unknown_column_requested":
        assert got is None  # the caller reads the file with pandas


@pytest.mark.parametrize("case", sorted(BAD_ROWS))
def test_native_refuses_what_the_reference_refuses(native_lib, case):
    with pytest.raises(ValueError) as ours:
        native_lib.parse_jsonl_buffer(BAD_ROWS[case], ref_rb._TRAIN_COLS)
    with pytest.raises(ValueError) as ref:
        ref_native.parse_jsonl_buffer(BAD_ROWS[case], ref_rb._TRAIN_COLS)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("n_threads", [1, 3, 0])
def test_native_threads_agree(native_lib, n_threads):
    raw = _buffer_df(997, seed=5).to_json(orient="records", lines=True).encode()
    _assert_columns_equal(native_lib.parse_jsonl_buffer(raw, ref_rb._TRAIN_COLS, n_threads),
                          ref_native.parse_jsonl_buffer(raw, ref_rb._TRAIN_COLS))


def test_native_library_lives_in_the_ports_build_dir(native_lib):
    from ikea_recommender_tpu_torch.ops import build

    path = build.host_library_path(native.SOURCE)
    assert path.exists() and path.parent == build.BUILD_DIR


# ---- data/replay_buffer.py: JSON lines ---------------------------------------


def _write_jsonl(path, df, blank_tail=False):
    """JSON lines written with the json module (as a machine without pandas
    would write them)."""
    with open(path, "w") as fh:
        for row in df.to_dict(orient="records"):
            fh.write(json.dumps({k: (v.item() if hasattr(v, "item") else v)
                                 for k, v in row.items()}) + "\n")
        if blank_tail:
            fh.write("\n  \n")


@pytest.mark.parametrize("blank_tail", [False, True])
def test_replay_buffer_jsonl_round_trip(native_lib, tmp_path, blank_tail):
    df = _buffer_df(200, state_len=5, seed=3)
    path = str(tmp_path / "buf.jsonl")
    _write_jsonl(path, df, blank_tail)
    before = native_lib.NATIVE_PARSES
    buf = replay_buffer.ReplayBuffer(path)
    assert native_lib.NATIVE_PARSES == before + 1
    ref = ref_rb.ReplayBuffer(path)
    for name in ("state", "action", "reward", "next_state", "true_len", "true_next_len", "is_end"):
        np.testing.assert_array_equal(getattr(buf, name), getattr(ref, name), err_msg=name)
        assert getattr(buf, name).dtype == getattr(ref, name).dtype
    np.testing.assert_array_equal(buf.state, np.asarray(df["state"].tolist()))
    np.testing.assert_array_equal(buf.reward, df["r_act"].to_numpy(np.float32))
    ev = replay_buffer.EvalBuffer(path)
    np.testing.assert_array_equal(ev.true_len, ref_rb.EvalBuffer(path).true_len)


def test_replay_buffer_jsonl_pandas_fallback(tmp_path, monkeypatch):
    """Without the native library the port reads the same arrays through
    pandas, and counts no native parse."""
    df = _buffer_df(60, state_len=4, seed=8)
    path = str(tmp_path / "buf.jsonl")
    _write_jsonl(path, df)
    monkeypatch.setattr(native, "load_library", lambda: None)
    before = native.NATIVE_PARSES
    buf = replay_buffer.ReplayBuffer(path)
    assert native.NATIVE_PARSES == before
    ref = ref_rb.ReplayBuffer(path)
    for name in ("state", "action", "next_state", "true_len", "true_next_len", "is_end"):
        np.testing.assert_array_equal(getattr(buf, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(buf.reward, ref.reward, rtol=0, atol=0)


def test_replay_buffer_jsonl_with_action_type(native_lib, tmp_path):
    """A column the parser does not know (action_type) sends the file to
    pandas on both sides, and the column survives."""
    df = _buffer_df(40, state_len=3, seed=9).assign(action_type=lambda d: d["action"] % 3)
    path = str(tmp_path / "buf.jsonl")
    _write_jsonl(path, df)
    buf, ref = replay_buffer.ReplayBuffer(path), ref_rb.ReplayBuffer(path)
    np.testing.assert_array_equal(buf.action_type, ref.action_type)
    np.testing.assert_array_equal(buf.state, ref.state)


def test_jsonl_buffers_load_without_pandas(native_lib, tmp_path, monkeypatch):
    """Prebuilt JSON-lines train and eval buffers, the eval one through
    ``load_eval_source`` (which tells a buffer from a raw session file by
    its first row), load with pandas unimportable."""
    import sys

    df = _buffer_df(30, state_len=4, seed=11)
    train_path, eval_path = str(tmp_path / "train.jsonl"), str(tmp_path / "val.jsonl")
    _write_jsonl(train_path, df)
    _write_jsonl(eval_path, df[["state", "action", "true_state_len"]], blank_tail=True)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    buf = replay_buffer.ReplayBuffer(train_path)
    ev = replay_buffer.load_eval_source(eval_path, padding_id=100, state_len=4)
    np.testing.assert_array_equal(buf.state, np.asarray(df["state"].tolist()))
    np.testing.assert_array_equal(ev.state, buf.state)
    np.testing.assert_array_equal(ev.true_len, df["true_state_len"].to_numpy())
