"""The eval harness against the port's server, on the standard library only
(port of eval_harness/client.py, runner.py and scripts/quality_eval.py,
which import requests and yaml; the card's machine has neither). The data
and metric modules of eval_harness/ (corpus, its data, metrics) are used
as they are."""
