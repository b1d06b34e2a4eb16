"""Entries: one module per timed path (`<entry>.py`), each with
`setup(ctx) -> state`, `window(state, seconds) -> counters` and
`check(state) -> {compared number: reading}`."""
