"""mfu.train (%): readers.mfu_train, both training cells."""

import readers

read = readers.mfu_train
