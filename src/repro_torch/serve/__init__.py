"""Session-style host APIs over the live sharded state (counterpart of
`repro/serve`): `serve/query.py` holds the query plane's records and
device stages, `serve/session.py` the host-side ServeSession that
interleaves update chunks with query admissions over both drivers, and
`serve/train_session.py` the TrainSession that interleaves update chunks
with label admissions for the training plane."""
