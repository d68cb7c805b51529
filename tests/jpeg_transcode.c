/* Rewrite a JPEG's DCT coefficients, losslessly, with other entropy coding
 * or another scan layout: a test helper that makes arithmetic-coded and
 * progressive files from a Huffman one, so that both image decoders can be
 * held to the same coefficients (tests/test_torch_jpeg.py,
 * tests/make_jpeg_fixtures.py). It needs libjpeg:
 *
 *   gcc -O2 -o jpeg_transcode tests/jpeg_transcode.c -ljpeg
 *   jpeg_transcode [-a] [-p | -s SCRIPT] [-r N] [-d L,U,K] in.jpg out.jpg
 *
 *   -a         arithmetic coding (SOF9; SOF10 with -p or a progressive -s)
 *   -p         progressive, with jpeg_simple_progression's scan script
 *   -s SCRIPT  the scans of SCRIPT: scans separated by ';', each
 *              "c[,c...]:Ss-Se,Ah,Al" with component indices, e.g.
 *              "0,1,2:0-0,0,0;0:1-63,0,0;1:1-63,0,0;2:1-63,0,0"
 *   -r N       a restart interval of N MCUs
 *   -d L,U,K   the DAC conditioning of every arithmetic table:
 *              arith_dc_L, arith_dc_U and arith_ac_K (default 0,1,5)
 *
 * Exits 1 with libjpeg's message when it refuses.
 */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#define MAX_SCANS 64

struct err {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void on_error(j_common_ptr cinfo) {
  (*cinfo->err->output_message)(cinfo);
  longjmp(((struct err *)cinfo->err)->jb, 1);
}

static int parse_script(const char *text, jpeg_scan_info *scans) {
  int n = 0;
  const char *p = text;
  while (*p) {
    jpeg_scan_info *s = &scans[n];
    int used = 0;
    if (n == MAX_SCANS) return -1;
    s->comps_in_scan = 0;
    for (;;) {
      int c;
      if (sscanf(p, "%d%n", &c, &used) != 1 || s->comps_in_scan == 4)
        return -1;
      s->component_index[s->comps_in_scan++] = c;
      p += used;
      if (*p == ',') {
        ++p;
        continue;
      }
      if (*p++ != ':') return -1;
      break;
    }
    if (sscanf(p, "%d-%d,%d,%d%n", &s->Ss, &s->Se, &s->Ah, &s->Al, &used)
        != 4)
      return -1;
    p += used;
    ++n;
    if (*p == ';') ++p;
    else if (*p) return -1;
  }
  return n;
}

int main(int argc, char **argv) {
  int arith = 0, progressive = 0, restart = 0, dac = 0, n_scans = 0;
  int L = 0, U = 1, K = 5, i;
  const char *script = NULL;
  jpeg_scan_info scans[MAX_SCANS];
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct err jerr;
  jvirt_barray_ptr *coefs;
  FILE *in, *out;

  for (i = 1; i < argc - 2; ++i) {
    if (!strcmp(argv[i], "-a")) {
      arith = 1;
    } else if (!strcmp(argv[i], "-p")) {
      progressive = 1;
    } else if (!strcmp(argv[i], "-s") && i + 1 < argc - 2) {
      script = argv[++i];
    } else if (!strcmp(argv[i], "-r") && i + 1 < argc - 2) {
      restart = atoi(argv[++i]);
    } else if (!strcmp(argv[i], "-d") && i + 1 < argc - 2 &&
               sscanf(argv[i + 1], "%d,%d,%d", &L, &U, &K) == 3) {
      dac = 1;
      ++i;
    } else {
      break;
    }
  }
  if (i != argc - 2) {
    fprintf(stderr, "usage: %s [-a] [-p | -s SCRIPT] [-r N] [-d L,U,K] "
                    "in.jpg out.jpg\n", argv[0]);
    return 2;
  }
  if (script && (n_scans = parse_script(script, scans)) <= 0) {
    fprintf(stderr, "%s: bad scan script '%s'\n", argv[0], script);
    return 2;
  }
  if (!(in = fopen(argv[argc - 2], "rb"))) {
    perror(argv[argc - 2]);
    return 1;
  }
  if (!(out = fopen(argv[argc - 1], "wb"))) {
    perror(argv[argc - 1]);
    return 1;
  }
  src.err = jpeg_std_error(&jerr.mgr);
  dst.err = &jerr.mgr;
  jerr.mgr.error_exit = on_error;
  if (setjmp(jerr.jb)) return 1;
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = FALSE;
  dst.restart_interval = restart;
  if (progressive) jpeg_simple_progression(&dst);
  if (script) {
    dst.scan_info = scans;
    dst.num_scans = n_scans;
  }
  if (dac) {
    for (i = 0; i < NUM_ARITH_TBLS; ++i) {
      dst.arith_dc_L[i] = (UINT8)L;
      dst.arith_dc_U[i] = (UINT8)U;
      dst.arith_ac_K[i] = (UINT8)K;
    }
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_compress(&dst);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}
