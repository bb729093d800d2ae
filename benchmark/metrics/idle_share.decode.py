"""idle_share.decode (%): readers.idle_share, the decode cells."""

import readers

read = readers.idle_share
