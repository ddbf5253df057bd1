/* Parity driver for the reference MISO C engine (libsplicing).
 *
 * Our framework's acceptance criterion is statistical equivalence with
 * the reference implementation (ROADMAP.md).  This driver runs the
 * UNMODIFIED reference engine (built from /root/reference/pysplicing by
 * tests/refparity.py) on arbitrary (gff, reads) inputs so the test
 * suite can compare miso_jax posteriors against reference posteriors on
 * identical data -- a live oracle instead of the stale shipped
 * fixtures (which predate the fastmiso C engine; see docs/PARITY.md).
 *
 * Usage:
 *   ref_driver GFF_FILE GENE_IDX READLEN OVERHANG CHAINS ITERS BURNIN \
 *              LAG ALGORITHM SEED [MEANFRAG SDFRAG NUMDEVS] < reads.txt
 * reads.txt: one "position<TAB>cigar" per line (1-based positions).
 * With the 3 trailing args the paired sampler is used; reads are
 * consecutive mate pairs.
 * Output:
 *   "classes" lines: template tuple + count   (read-class parity)
 *   "assigned" line: per-isoform final counts (-1s excluded)
 *   "sample" lines: psi vector + logLik       (posterior parity)
 *
 * Reference API: pysplicing/include/splicing.h:203 (splicing_miso),
 * :218 (splicing_miso_paired); the Python caller it mirrors is
 * misopy/miso_sampler.py:279-346 via pysplicing.c:41-244.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "splicing.h"
#include "splicing_random.h"

static void die(const char *msg) {
  fprintf(stderr, "ref_driver: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc != 11 && argc != 14) die("bad argc");
  const char *gff_file = argv[1];
  size_t gene = (size_t) atoi(argv[2]);
  int read_len = atoi(argv[3]);
  int overhang = atoi(argv[4]);
  int chains = atoi(argv[5]);
  int iters = atoi(argv[6]);
  int burn_in = atoi(argv[7]);
  int lag = atoi(argv[8]);
  int algorithm = atoi(argv[9]); /* 0 reassign, 1 marginal, 2 classes */
  unsigned long seed = (unsigned long) atol(argv[10]);
  int paired = (argc == 14);
  double mean_frag = paired ? atof(argv[11]) : 0.0;
  double var_frag = paired ? atof(argv[12]) * atof(argv[12]) : 0.0;
  int num_devs = paired ? atoi(argv[13]) : 0;

  splicing_rng_seed(&splicing_rng_default, seed);
  splicing_rng_default.def = 2; /* suppress time(0) reseed in RNG_BEGIN */

  FILE *gf = fopen(gff_file, "r");
  if (!gf) die("cannot open gff");
  splicing_gff_t gff;
  if (splicing_gff_init(&gff, 64)) die("gff init");
  if (splicing_gff_read(gf, &gff)) die("gff read");
  fclose(gf);

  /* reads from stdin */
  splicing_vector_int_t position;
  splicing_vector_int_init(&position, 0);
  char **cigars = NULL;
  size_t ncig = 0, cap = 0;
  char line[4096];
  while (fgets(line, sizeof line, stdin)) {
    long pos;
    char cig[4000];
    if (sscanf(line, "%ld\t%3999s", &pos, cig) != 2) continue;
    splicing_vector_int_push_back(&position, (int) pos);
    if (ncig == cap) {
      cap = cap ? cap * 2 : 64;
      cigars = (char **) realloc(cigars, cap * sizeof(char *));
    }
    cigars[ncig++] = strdup(cig);
  }

  splicing_vector_t hyperp;
  size_t noiso;
  splicing_gff_noiso_one(&gff, gene, &noiso);
  splicing_vector_init(&hyperp, noiso);
  {
    size_t i;
    for (i = 0; i < noiso; i++) VECTOR(hyperp)[i] = 1.0;
  }

  splicing_matrix_t samples;
  splicing_vector_t logLik;
  splicing_matrix_t class_templates;
  splicing_vector_t class_counts;
  splicing_vector_int_t assignment;
  splicing_miso_rundata_t rundata;
  splicing_matrix_init(&samples, 0, 0);
  splicing_vector_init(&logLik, 0);
  splicing_matrix_init(&class_templates, 0, 0);
  splicing_vector_init(&class_counts, 0);
  splicing_vector_int_init(&assignment, 0);

  int err;
  if (!paired) {
    err = splicing_miso(
        &gff, gene, &position, (const char **) cigars, read_len, overhang,
        chains, iters, /*maxIterations=*/iters * 100, burn_in, lag, &hyperp,
        (splicing_algorithm_t) algorithm, SPLICING_MISO_START_AUTO,
        SPLICING_MISO_STOP_FIXEDNO, /*start_psi=*/0, &samples, &logLik,
        /*match_matrix=*/0, &class_templates, &class_counts, &assignment,
        &rundata);
  } else {
    /* fragment-length pmf handled internally via normalMean/normalVar
     * (miso_paired.c:241: insertProb built by splicing_normal_fragment) */
    err = splicing_miso_paired(
        &gff, gene, &position, (const char **) cigars, read_len, overhang,
        chains, iters, /*maxIterations=*/iters * 100, burn_in, lag, &hyperp,
        SPLICING_MISO_START_AUTO, SPLICING_MISO_STOP_FIXEDNO,
        /*start_psi=*/0, /*fragmentProb=*/0, /*fragmentStart=*/0,
        mean_frag, var_frag, num_devs, &samples, &logLik,
        /*match_matrix=*/0, &class_templates, &class_counts,
        /*bin_class_templates=*/0, /*bin_class_count=*/0, &assignment,
        &rundata);
  }
  if (err) die("splicing_miso failed");

  /* read classes (miso.c:763 splicing_i_miso_classes output) */
  {
    long c, i;
    long C = (long) splicing_matrix_ncol(&class_templates);
    for (c = 0; c < C; c++) {
      printf("class\t");
      for (i = 0; i < (long) noiso; i++)
        printf("%s%d", i ? "," : "",
               (int) MATRIX(class_templates, i, c) != 0);
      printf("\t%d\n", (int) VECTOR(class_counts)[c]);
    }
  }
  /* final per-isoform assigned counts, -1 (incompatible) excluded
   * (misopy/miso_sampler.py count_isoform_assignments) */
  {
    long r, n = (long) splicing_vector_int_size(&assignment);
    long *cnt = (long *) calloc(noiso, sizeof(long));
    for (r = 0; r < n; r++) {
      int a = VECTOR(assignment)[r];
      if (a >= 0 && a < (int) noiso) cnt[a]++;
    }
    printf("assigned");
    for (r = 0; r < (long) noiso; r++) printf("\t%ld", cnt[r]);
    printf("\n");
    free(cnt);
  }
  printf("accepted\t%d\t%d\n", rundata.noAccepted, rundata.noRejected);
  /* samples: (noiso x noSamples), logLik per sample */
  {
    long s, i;
    long S = (long) splicing_matrix_ncol(&samples);
    for (s = 0; s < S; s++) {
      printf("sample\t");
      for (i = 0; i < (long) noiso; i++)
        printf("%s%.6f", i ? "," : "", MATRIX(samples, i, s));
      printf("\t%.4f\n", VECTOR(logLik)[s]);
    }
  }
  return 0;
}
