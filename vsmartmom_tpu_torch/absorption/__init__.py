"""Line-by-line gas absorption and continua (counterpart of the JAX
package's ``absorption/``): HITRAN line lists and tables (``hitran``), the
Voigt complex error functions (``voigt``), cross sections and their
look-up tables (``cross_section``, whose line sum runs on a torch device),
CIA and MT_CKD continua (``continuum``) and the local line-file registry
(``artifacts``)."""
