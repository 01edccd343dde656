"""pytest settings for the whole repo.

Copies of the tree for runs on the card are unpacked into git-ignored
directories of the repo (``chip_scratch/``, ``archive_check/``). Each copy
holds its own ``tests/`` and ``bench/``, and collecting them would import a
second module under each test file's name, so pytest leaves them out.
"""

collect_ignore = ["chip_scratch", "archive_check"]
