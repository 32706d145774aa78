"""Rule-based query paraphrasing for contrastive / judge training (the
port's copy of rust_local_rag_tpu/training/paraphrase.py, numpy only).

The round-2 diagnosis (train_reranker.py docstring, VERDICT r2 missing #3):
judges trained on VERBATIM word crops are confidently wrong on paraphrase
queries — the serving distribution. This module manufactures the
paraphrase gap programmatically: a cropped query is rewritten with
register-preserving synonym substitutions, light function-word dropping,
and natural question framing, so the positive pair (query', passage) no
longer copy-matches the passage at the substituted positions.

The synonym table maps the technical-documentation register the training
corpus is written in (package docstrings) to everyday near-equivalents a
user would type. Substitutions are single-word and meaning-preserving at
the granularity retrieval cares about; they deliberately BREAK exact
lexical overlap, which is the point.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

# word -> alternatives (lowercase keys; replacement preserves nothing of
# the original casing — queries are lowercased by tokenizers anyway)
SYNONYMS = {
    # verbs of computation and change
    "returns": ["gives back", "yields", "produces", "hands back"],
    "return": ["give back", "yield", "produce", "hand back"],
    "returned": ["given back", "produced"],
    "computes": ["calculates", "works out", "figures out"],
    "compute": ["calculate", "work out", "figure out"],
    "computed": ["calculated", "worked out"],
    "creates": ["builds", "makes", "constructs", "sets up"],
    "create": ["build", "make", "construct", "set up"],
    "created": ["built", "made", "constructed"],
    "removes": ["deletes", "drops", "gets rid of", "strips"],
    "remove": ["delete", "drop", "get rid of", "strip"],
    "removed": ["deleted", "dropped"],
    "modifies": ["changes", "alters", "updates", "mutates"],
    "modify": ["change", "alter", "update", "mutate"],
    "modified": ["changed", "altered", "updated"],
    "contains": ["holds", "includes", "carries", "has"],
    "contain": ["hold", "include", "carry"],
    "specifies": ["sets", "defines", "picks", "chooses"],
    "specify": ["set", "define", "pick", "choose"],
    "specified": ["given", "set", "chosen"],
    "raises": ["throws", "triggers", "produces"],
    "raise": ["throw", "trigger"],
    "raised": ["thrown", "triggered"],
    "converts": ["turns", "transforms", "changes"],
    "convert": ["turn", "transform", "change"],
    "performs": ["does", "runs", "executes", "carries out"],
    "perform": ["do", "run", "execute", "carry out"],
    "requires": ["needs", "demands", "expects"],
    "require": ["need", "demand", "expect"],
    "required": ["needed", "mandatory"],
    "determines": ["decides", "controls", "governs"],
    "determine": ["decide", "control", "govern"],
    "indicates": ["shows", "signals", "means"],
    "indicate": ["show", "signal", "mean"],
    "generates": ["produces", "makes", "emits"],
    "generate": ["produce", "make", "emit"],
    "provides": ["offers", "supplies", "gives"],
    "provide": ["offer", "supply", "give"],
    "supports": ["allows", "handles", "accepts"],
    "support": ["allow", "handle", "accept"],
    "obtains": ["gets", "fetches", "retrieves"],
    "obtain": ["get", "fetch", "retrieve"],
    "stores": ["keeps", "saves", "records"],
    "store": ["keep", "save", "record"],
    "stored": ["kept", "saved", "recorded"],
    "checks": ["tests", "verifies", "validates"],
    "check": ["test", "verify", "validate"],
    "ensures": ["guarantees", "makes sure"],
    "ensure": ["guarantee", "make sure"],
    "applies": ["uses", "runs"],
    "apply": ["use", "run"],
    "applied": ["used", "run"],
    "ignores": ["skips", "discards", "drops"],
    "ignore": ["skip", "discard", "drop"],
    "ignored": ["skipped", "discarded"],
    "selects": ["picks", "chooses"],
    "select": ["pick", "choose"],
    "selected": ["picked", "chosen"],
    "begins": ["starts"],
    "begin": ["start"],
    "terminates": ["ends", "stops", "finishes"],
    "terminate": ["end", "stop", "finish"],
    "receives": ["gets", "takes", "accepts"],
    "receive": ["get", "take", "accept"],
    "displays": ["shows", "renders", "prints"],
    "display": ["show", "render", "print"],
    "updates": ["refreshes", "changes"],
    "update": ["refresh", "change"],
    "calls": ["invokes", "runs"],
    "call": ["invoke", "run"],
    "called": ["invoked", "named"],
    "loads": ["reads in", "opens", "imports"],
    "load": ["read in", "open", "import"],
    "loaded": ["read in", "opened"],
    "writes": ["saves", "outputs", "dumps"],
    "write": ["save", "output", "dump"],
    "written": ["saved", "output"],
    "allocates": ["reserves", "grabs"],
    "allocate": ["reserve", "grab"],
    "enables": ["turns on", "activates", "switches on"],
    "enable": ["turn on", "activate", "switch on"],
    "disables": ["turns off", "deactivates", "switches off"],
    "disable": ["turn off", "deactivate", "switch off"],
    # nouns of the register
    "function": ["routine", "method", "call"],
    "functions": ["routines", "methods", "calls"],
    "parameter": ["argument", "option", "setting"],
    "parameters": ["arguments", "options", "settings"],
    "argument": ["parameter", "input", "option"],
    "arguments": ["parameters", "inputs", "options"],
    "error": ["failure", "problem", "fault"],
    "errors": ["failures", "problems", "faults"],
    "exception": ["error", "failure"],
    "exceptions": ["errors", "failures"],
    "value": ["result", "quantity", "entry"],
    "values": ["results", "quantities", "entries"],
    "array": ["matrix", "tensor", "grid of numbers"],
    "arrays": ["matrices", "tensors"],
    "element": ["entry", "item", "cell"],
    "elements": ["entries", "items", "cells"],
    "column": ["field", "variable"],
    "columns": ["fields", "variables"],
    "row": ["record", "entry"],
    "rows": ["records", "entries"],
    "method": ["function", "routine", "operation"],
    "methods": ["functions", "routines", "operations"],
    "object": ["instance", "item", "thing"],
    "objects": ["instances", "items", "things"],
    "string": ["text", "piece of text"],
    "strings": ["texts", "text values"],
    "integer": ["whole number", "int"],
    "integers": ["whole numbers", "ints"],
    "boolean": ["true/false flag", "flag"],
    "default": ["standard", "preset", "out-of-the-box"],
    "defaults": ["standard settings", "presets"],
    "output": ["result", "product"],
    "outputs": ["results", "products"],
    "input": ["source", "argument"],
    "inputs": ["sources", "arguments"],
    "result": ["outcome", "answer", "output"],
    "results": ["outcomes", "answers", "outputs"],
    "dimension": ["axis", "direction"],
    "dimensions": ["axes", "directions"],
    "axis": ["dimension", "direction"],
    "axes": ["dimensions", "directions"],
    "index": ["position", "location", "offset"],
    "indices": ["positions", "locations", "offsets"],
    "shape": ["size", "dimensions", "layout"],
    "size": ["length", "extent", "dimensions"],
    "length": ["size", "extent", "span"],
    "number": ["count", "amount", "quantity"],
    "numbers": ["counts", "amounts", "quantities"],
    "list": ["sequence", "collection", "series"],
    "lists": ["sequences", "collections", "series"],
    "dictionary": ["mapping", "lookup table", "dict"],
    "matrix": ["array", "grid", "table of numbers"],
    "matrices": ["arrays", "grids"],
    "file": ["document", "path"],
    "files": ["documents", "paths"],
    "directory": ["folder", "path"],
    "attribute": ["property", "field"],
    "attributes": ["properties", "fields"],
    "distribution": ["spread", "probability law"],
    "probability": ["chance", "likelihood"],
    "frequency": ["rate", "how often"],
    "gradient": ["slope", "derivative"],
    "gradients": ["slopes", "derivatives"],
    "model": ["network", "estimator"],
    "models": ["networks", "estimators"],
    "dataset": ["data", "training set"],
    "data": ["observations", "samples", "records"],
    "sample": ["example", "observation", "draw"],
    "samples": ["examples", "observations", "draws"],
    "label": ["target", "class", "tag"],
    "labels": ["targets", "classes", "tags"],
    "feature": ["variable", "attribute", "column"],
    "features": ["variables", "attributes", "columns"],
    "memory": ["ram", "storage"],
    "performance": ["speed", "throughput"],
    "documentation": ["docs", "manual"],
    "example": ["sample", "illustration", "demo"],
    "examples": ["samples", "illustrations", "demos"],
    "module": ["package", "library"],
    "modules": ["packages", "libraries"],
    "operation": ["action", "step", "computation"],
    "operations": ["actions", "steps", "computations"],
    "format": ["layout", "encoding", "representation"],
    "precision": ["accuracy", "number of digits"],
    "threshold": ["cutoff", "limit", "floor"],
    "callback": ["hook", "handler"],
    "iteration": ["pass", "loop step", "round"],
    "iterations": ["passes", "loop steps", "rounds"],
    "training": ["fitting", "learning"],
    "weights": ["parameters", "coefficients"],
    "layer": ["stage", "block"],
    "layers": ["stages", "blocks"],
    "batch": ["group", "chunk", "minibatch"],
    "batches": ["groups", "chunks", "minibatches"],
    # adjectives / adverbs
    "invalid": ["bad", "illegal", "malformed"],
    "valid": ["legal", "acceptable", "well-formed"],
    "identical": ["the same", "equal", "matching"],
    "different": ["distinct", "separate", "unequal"],
    "optional": ["not required", "elective"],
    "multiple": ["several", "many", "more than one"],
    "additional": ["extra", "more", "further"],
    "previous": ["earlier", "prior", "preceding"],
    "following": ["next", "subsequent", "later"],
    "automatically": ["by itself", "implicitly", "on its own"],
    "immediately": ["right away", "instantly", "at once"],
    "efficient": ["fast", "cheap", "economical"],
    "efficiently": ["quickly", "cheaply"],
    "large": ["big", "huge", "sizable"],
    "small": ["tiny", "little", "compact"],
    "empty": ["blank", "zero-length", "bare"],
    "equal": ["identical", "the same as"],
    "equivalent": ["the same as", "interchangeable with"],
    "maximum": ["largest", "top", "highest"],
    "minimum": ["smallest", "lowest", "bottom"],
    "current": ["present", "active", "existing"],
    "original": ["initial", "source", "first"],
    "specific": ["particular", "given", "certain"],
    "entire": ["whole", "full", "complete"],
}

# function-ish words safe to drop from a query without changing intent
_DROPPABLE = {
    "the", "a", "an", "of", "is", "are", "be", "will", "that", "this",
    "then", "was", "were", "been", "its", "their", "any", "all", "also",
    "can", "may", "which", "with", "for", "and", "or", "to", "in", "on",
    "by", "as", "it", "if",
}

# question frames a user actually types (applied to a fraction of queries)
_FRAMES = [
    "how do i {q}",
    "how does {q} work",
    "why does {q}",
    "what happens when {q}",
    "what is the point of {q}",
    "explain {q}",
    "can someone explain {q}",
    "question about {q}",
    "help with {q}",
    "when should i use {q}",
    "what does {q} mean",
    "trouble understanding {q}",
]

_WORD_RE = re.compile(r"[A-Za-z0-9_']+|[^\sA-Za-z0-9_']+")


def paraphrase(
    text: str,
    rng: np.random.Generator,
    synonym_prob: float = 0.85,
    drop_prob: float = 0.35,
    frame_prob: float = 0.4,
) -> str:
    """Rewrite a cropped query so it no longer copy-matches its source.

    Every dictionary word hits a synonym with `synonym_prob`; droppable
    function words vanish with `drop_prob`; with `frame_prob` the result
    is wrapped in a natural question frame. Deterministic given the rng.
    """
    words = text.split()
    out: List[str] = []
    for w in words:
        lw = w.lower().strip(".,;:()[]\"'")
        if lw in _DROPPABLE and rng.random() < drop_prob:
            continue
        alts = SYNONYMS.get(lw)
        if alts is not None and rng.random() < synonym_prob:
            out.append(alts[int(rng.integers(0, len(alts)))])
        else:
            out.append(w)
    if not out:
        out = words[:2] or [text]
    q = " ".join(out)
    if rng.random() < frame_prob:
        q = _FRAMES[int(rng.integers(0, len(_FRAMES)))].format(q=q)
    return q
