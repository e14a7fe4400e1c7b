"""Session-style host APIs over the live sharded state (counterpart of
`repro/serve`): `serve/query.py` holds the query plane's records and
device stages, `serve/session.py` the host-side ServeSession that
interleaves update chunks with query admissions over both drivers. The
training session comes with the training slice."""
