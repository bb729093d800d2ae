"""mfu.decode (%): readers.mfu_decode, the decode cells."""

import readers

read = readers.mfu_decode
