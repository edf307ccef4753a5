"""The port's benchmark evaluators (`vila_tpu_torch/eval/benchmarks.py`)
against the JAX package's (`vila_tpu/eval/benchmarks.py`) on the inputs of
`tests/test_benchmarks.py`:

* every scorer and parser, case by case, gives the JAX package's value;
* `run_benchmark` over a canned engine gives the same results, metrics and
  prompts for every task family;
* over the committed pope-mini fixture with an oracle, media paths resolve
  against the fixture directory the port finds from its own location;
* a real engine: the committed quant probe loaded by both packages on the
  CPU answers the first pope-mini questions alike, serially and through
  the port's continuous batcher.
"""

import json
import os

import pytest

from vila_tpu.eval import benchmarks as J
from vila_tpu_torch.eval import benchmarks as T

HUMANS = ["cat"] * 3 + ["dog"] * 7
HUMANS2 = ["cat", "dog", "dog", "dog", "bird"] + ["fish"] * 5
CANDS = [["a", "cat", "sits", "on", "the", "mat"], ["a", "dog", "runs", "in", "the", "park"]]
REFS = [[c] for c in CANDS]
BAD = [["completely", "unrelated", "words"], ["nothing", "in", "common", "at", "all"]]

SCORERS = [
    ("vqa_normalize", ("The Cat.",)), ("vqa_normalize", ("two",)),
    ("vqa_normalize", ("1,000",)), ("vqa_normalize", ("dont",)),
    ("vqa_accuracy", ("cat", HUMANS)), ("vqa_accuracy", ("dog", HUMANS)),
    ("vqa_accuracy", ("cat", HUMANS2)), ("vqa_accuracy", ("zebra", HUMANS2)),
    ("parse_choice", ("B", ["red", "green", "blue"])),
    ("parse_choice", ("(C) blue", ["red", "green", "blue"])),
    ("parse_choice", ("The answer is A.", ["red", "green", "blue"])),
    ("parse_choice", ("I think it's green", ["red", "green", "blue"])),
    ("parse_choice", ("no idea", ["red", "green", "blue"])),
    ("parse_choice", ("D", ["red", "green", "blue"])),
    ("format_mc_prompt", ("What color?", ["red", "green"])),
    ("parse_box", ("no box here",)), ("parse_box", ("at [0.2,0.3, 0.4 ,0.5] roughly",)),
    ("box_iou", ([0, 0, 1, 1], [0, 0, 1, 1])), ("box_iou", ([0, 0, 1, 1], [1, 1, 2, 2])),
    ("extract_number", ("first 3 then 4.5",)), ("extract_number", ("1,234 items",)),
    ("extract_number", ("none",)),
    ("edit_distance", ("kitten", "sitting")), ("edit_distance", ("", "abc")),
    ("anls_score", ("hello", ["hello"])), ("anls_score", ("hullo", ["hello"])),
    ("anls_score", ("zzzzz", ["hello"])), ("anls_score", ("42", ["41", "42"])),
    ("anls_score", ("  The Answer ", ["the answer"])),
    ("relaxed_match", ("20.5", "20")), ("relaxed_match", ("22", "20")),
    ("relaxed_match", ("The value is 104", "100")), ("relaxed_match", ("Yes", "yes")),
    ("relaxed_match", ("maybe", "yes")), ("relaxed_match", ("0", "0")),
    ("_cap_tokenize", ("A cat, sits on the mat!",)),
    ("cider_d", (CANDS, REFS)), ("cider_d", (BAD, REFS)),
    ("bleu4", (CANDS, REFS)), ("bleu4", (BAD, REFS)),
]


@pytest.mark.parametrize("name,args", SCORERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCORERS)])
def test_scorer_matches_jax(name, args):
    assert getattr(T, name)(*args) == getattr(J, name)(*args)


class FakeEngine:
    """Answers by looking up a canned table keyed on the question text."""

    def __init__(self, table):
        self.table = table
        self.prompts = []

    def generate_content(self, prompt, gen=None):
        self.prompts.append([p if isinstance(p, str) else type(p).__name__ for p in prompt])
        for key, ans in self.table.items():
            if key in prompt[-1]:
                return ans
        return "unknown"


RUNS = [
    ("textvqa", [{"image": None, "question": "what is shown", "answers": ["cat"] * 10},
                 {"image": None, "question": "how many", "answers": ["two"] * 5 + ["three"] * 5}],
     {"what is shown": "a cat", "how many": "2"}),
    ("scienceqa", [{"image": None, "question": "pick one", "choices": ["apple", "pear"],
                    "answer": 1}], {"pick one": "B. pear"}),
    ("gqa", [{"image": None, "question": "what fruit", "answer": "the apple"}],
     {"what fruit": "Apple."}),
    ("pope", [{"image": None, "question": "is there a dog", "answer": "yes"},
              {"image": None, "question": "is there a cat", "answer": "no"},
              {"image": None, "question": "is there a car", "answer": "yes"}],
     {"dog": "Yes, there is.", "cat": "yes", "car": "No."}),
    ("videomme", [{"video": None, "question": "what happens",
                   "choices": ["runs", "sits", "eats", "sleeps"], "answer": "C"}],
     {"what happens": "C"}),
    ("refcoco", [{"image": None, "question": "find the dog", "answer": [0.1, 0.1, 0.5, 0.5]}],
     {"find the dog": "The box is [0.1, 0.1, 0.5, 0.5]."}),
    ("refcoco", [{"image": None, "question": "find the dog", "answer": [0.1, 0.1, 0.5, 0.5]}],
     {"find the dog": "[0.6, 0.6, 0.9, 0.9]"}),
    ("mathvista", [{"image": None, "question": "what is 2+2", "answer": 4}],
     {"2+2": "The answer is 4."}),
    ("mathvista", [{"image": None, "question": "pick", "choices": ["1", "2"], "answer": 1}],
     {"pick": "B"}),
    ("docvqa", [{"image": None, "question": "invoice number", "answers": ["INV-001"]}],
     {"invoice number": "inv-001"}),
    ("chartqa", [{"image": None, "question": "peak value", "answer": "100"}],
     {"peak value": "about 98"}),
    ("mme", [{"image": "a.jpg", "category": "color", "question": "is it red", "answer": "yes"},
             {"image": "a.jpg", "category": "color", "question": "is it blue", "answer": "no"},
             {"image": "b.jpg", "category": "color", "question": "is it green", "answer": "yes"},
             {"image": "b.jpg", "category": "color", "question": "is it black", "answer": "no"}],
     {"is it red": "Yes", "is it blue": "No", "is it green": "Yes", "is it black": "Yes"}),
    ("ocrbench", [{"image": None, "question": "read the text", "answers": ["Hello World"]}],
     {"read the text": 'It says "hello world" on the sign'}),
    ("tallyqa", [{"image": None, "question": "how many cats", "answer": 3, "issimple": True},
                 {"image": None, "question": "how many dogs on sofas", "answer": 2,
                  "issimple": False}], {"how many cats": "There are 3.", "how many dogs": "4"}),
    ("mmmu", [{"image": None, "question": "which shape", "choices": ["circle", "square"],
               "answer": "B"}], {"which shape": "B. square"}),
    ("egoschema", [{"video": None, "question": "what happens", "choices": ["runs", "jumps"],
                    "answer": 0}], {"what happens": "A"}),
    ("caption", [{"image": None, "question": "Caption the figure.",
                  "answers": ["a bar chart of sales", "sales bar chart"]},
                 {"image": None, "question": "Describe the photo.",
                  "answers": ["a red bird on a branch"]}],
     {"Caption the figure.": "a bar chart of sales",
      "Describe the photo.": "a red bird on a branch"}),
    ("vizwiz", [{"image": None, "question": "what is this", "answers": ["unanswerable"] * 10}],
     {"what is this": "Unanswerable"}),
    ("videomme_sub", [{"video": None, "question": "what is said",
                       "choices": ["hello", "bye", "maybe", "never"], "answer": "A",
                       "subtitles": "Speaker: hello world"}], {"what is said": "A"}),
    ("mmmu_open", [{"image": None, "question": "value of x", "answer": "42"},
                   {"image": None, "question": "pick color", "choices": ["red", "blue"],
                    "answer": 0}], {"value of x": "x equals 42.0", "pick color": "A"}),
    ("activitynetqa", [{"video": None, "question": "what does he do",
                        "answer": "playing guitar"},
                       {"video": None, "question": "what is the weather", "answer": "sunny"}],
     {"what does he do": "He is playing guitar on stage.", "what is the weather": "rainy"}),
    ("aitz", [{"image": None, "question": "next action?", "answer": "click(settings)"}],
     {"next action": "I would click on settings."}),
]


@pytest.mark.parametrize("task,ds,table", RUNS, ids=[f"{r[0]}-{i}" for i, r in enumerate(RUNS)])
def test_run_benchmark_matches_jax(task, ds, table, monkeypatch):
    monkeypatch.delenv("VILA_JUDGE_URL", raising=False)
    je, te = FakeEngine(table), FakeEngine(table)
    assert T.run_benchmark(te, task, ds) == J.run_benchmark(je, task, ds)
    assert te.prompts == je.prompts


def test_tasks_and_judge_gate(monkeypatch):
    assert sorted(T.TASKS) == sorted(J.TASKS)
    monkeypatch.delenv("VILA_JUDGE_URL", raising=False)
    assert T._llm_judge("q", "gold", "pred") is None
    with pytest.raises(ValueError, match="unknown benchmark"):
        T.run_benchmark(FakeEngine({}), "no-such-task", [])


def test_fixture_root_and_oracle_run():
    """The port finds the committed fixtures from its own location; an
    oracle keyed on (image, question) scores 1.0, a wrong one 0.0."""
    path = T.resolve_dataset("fixture:mini/pope.jsonl")
    assert path == J.resolve_dataset("fixture:mini/pope.jsonl") and os.path.exists(path)
    pope = T.load_dataset("fixture:mini/pope.jsonl")[:8]
    assert pope == J.load_dataset("fixture:mini/pope.jsonl")[:8]
    fdir = os.path.dirname(path)

    class Oracle:
        def __init__(self, wrong=False):
            self.wrong = wrong
            self.table = {(os.path.basename(r["image"]), r["question"]): r["answer"]
                          for r in pope}

        def generate_content(self, prompt, gen=None):
            img, question = prompt[0], prompt[-1]
            assert os.path.exists(img.path), img.path
            gold = self.table[(os.path.basename(img.path), question.split("\n")[0])]
            return "maybe not" if self.wrong else gold

    assert T.run_benchmark(Oracle(), "pope", pope, media_root=fdir)["metrics"][
        "pope/accuracy"] == 1.0
    assert T.run_benchmark(Oracle(True), "pope", pope, media_root=fdir)["metrics"][
        "pope/accuracy"] == 0.0


def test_probe_engine_pope_serial_and_batched_match_jax():
    """The committed quant probe through both packages' `entry.load` on the
    CPU (f32): the first 4 pope-mini questions give the same predictions
    and metrics; through the port's continuous batcher (2 slots) the same
    predictions in dataset order."""
    from vila_tpu import entry as jentry
    from vila_tpu_torch import entry as tentry

    probe = os.path.join(T.FIXTURE_ROOT, "quant_probe")
    path = T.resolve_dataset("fixture:mini/pope.jsonl")
    ds = T.load_dataset(path)[:4]
    fdir = os.path.dirname(path)
    want = J.run_benchmark(jentry.load(probe), "pope", ds, max_new_tokens=4, media_root=fdir)
    engine = tentry.load(probe, device="cpu")
    got = T.run_benchmark(engine, "pope", ds, max_new_tokens=4, media_root=fdir)
    assert got == want, json.dumps([r["prediction"] for r in got["results"]])
    batched = T.run_benchmark(engine, "pope", ds, max_new_tokens=4, media_root=fdir,
                              concurrency=2)
    assert [r["prediction"] for r in batched["results"]] == [
        r["prediction"] for r in got["results"]]
