"""Share of the traced window of train steps in which no kernel, copy or memset ran."""

from portbench.readers import idle_pct as read  # noqa: F401
