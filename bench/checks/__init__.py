"""One module a way of deciding ``correct``, named by the configuration's
``check``: ``compare(spec, kept, record, device, ranks)`` holds the states a
loop kept against the configuration's reference and returns the numbers
compared, each with its limit (``{name: {"value", "limit"}}``), and what it
reports of the state (not compared)."""
