"""Host-side input handling: the reference's image preprocessing and its
``.bin`` input format (``preprocess``), and synthetic training batches
(``loader``)."""
