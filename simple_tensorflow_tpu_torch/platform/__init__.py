"""Host platform helpers of the port: ranked locks (``sync``) and the
``/stf/*`` metrics and trace spans (``monitoring``) the input pipeline
reports through."""
