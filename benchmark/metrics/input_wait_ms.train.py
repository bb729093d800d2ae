"""input_wait_ms.train (ms): readers.input_wait_ms, both training cells."""

import readers

read = readers.input_wait_ms
