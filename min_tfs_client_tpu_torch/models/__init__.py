"""Model families (BERT in this slice) and version-directory I/O."""
