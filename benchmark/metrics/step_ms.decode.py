"""step_ms.decode (ms): readers.step_ms_decode, the decode cells."""

import readers

read = readers.step_ms_decode
