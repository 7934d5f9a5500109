"""One module a model family: its `Cell` runs a subject through the
port's public API and checks it against the plain references."""
