"""Launchers: the merge CLI (``merge_cli``)."""
