"""idle_share.train (%): readers.idle_share, both training cells."""

import readers

read = readers.idle_share
