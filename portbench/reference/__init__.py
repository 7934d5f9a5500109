"""Plain references the benchmark judges the port against: plain torch
and numpy, importing nothing of the program."""
