"""idle_share.serve: the share of the traced window's wall in which no
operation ran on the device, in %, as the result's ``device.busy_s`` and
``window_s`` give it. One reader serves this metric and idle_share.train."""

from portbench.trace import idle_share as read  # noqa: F401
