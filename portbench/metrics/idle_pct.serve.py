"""Share of the traced window of ``predict_batch`` calls in which no kernel, copy or memset ran."""

from portbench.readers import idle_pct as read  # noqa: F401
